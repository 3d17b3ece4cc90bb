"""The decoder stack as plain functions over a nested tensor dict.

Counterpart of ``repro.models.transformer`` for the dense family
(attention + SwiGLU) and the ssm family (mamba2: the SSD mixer alone,
d_ff = 0). The parameter dict has the reference's layout
(``param_shapes``: ``embed``, ``blocks`` stacked over layers — with the
mixer's weights nested under ``blocks["ssm"]`` — ``final_norm``,
``lm_head``), so weights bridge between the two packages key for key. The
reference's layer scan is a Python loop over the stacked block weights.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    attention_train,
    cross_entropy_loss,
    embed_tokens,
    lm_head_logits,
    rms_norm,
    swiglu_mlp,
)
from repro_torch.tree import tree_map

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


PORTED_FAMILIES = ("dense", "ssm")


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES or cfg.uses_moe or not cfg.embed_inputs:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet "
            f"(token models of the {' and '.join(PORTED_FAMILIES)} families only)"
        )


def _block_param_shapes(cfg: ModelConfig) -> Dict:
    d, ff = cfg.d_model, cfg.d_ff
    shapes: Dict = {"pre_norm": (d,)}
    if cfg.uses_attention:
        hd = cfg.resolved_head_dim
        q, kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
        shapes.update({"wq": (d, q), "wk": (d, kv), "wv": (d, kv), "wo": (q, d)})
        if cfg.qkv_bias:
            shapes.update({"bq": (q,), "bk": (kv,), "bv": (kv,)})
    if cfg.uses_ssm:
        shapes["ssm"] = ssm_lib.ssm_param_shapes(cfg)
    if ff > 0:
        shapes.update(
            {"mlp_norm": (d,), "w_gate": (d, ff), "w_up": (d, ff), "w_down": (ff, d)}
        )
    return shapes


def param_shapes(cfg: ModelConfig) -> Dict:
    """Full parameter dict of shapes (blocks stacked over num_layers)."""
    _require_ported(cfg)
    L = cfg.num_layers
    shapes: Dict = {
        "embed": (cfg.vocab_size, cfg.d_model),
        "blocks": _stack_shapes(_block_param_shapes(cfg), L),
        "final_norm": (cfg.d_model,),
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (cfg.d_model, cfg.vocab_size)
    return shapes


def _stack_shapes(shapes: Dict, L: int) -> Dict:
    return {k: _stack_shapes(v, L) if isinstance(v, dict) else (L, *v)
            for k, v in shapes.items()}


_ZERO_INIT = ("bq", "bk", "bv", "conv_bx", "conv_bB", "conv_bC", "dt_bias")


def _init_leaf(gen: torch.Generator, name: str, shape, dtype) -> torch.Tensor:
    """Fan-in scaled normal init; norms and biases zero; the SSM scalars as
    in Mamba-2 (the reference's ``_init_leaf``)."""
    device = gen.device
    if "norm" in name or name in _ZERO_INIT:
        return torch.zeros(shape, dtype=dtype, device=device)
    if name == "A_log":  # A in [1, 16)
        u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
        return torch.log(1.0 + 15.0 * u).to(dtype)
    if name == "D":
        return torch.ones(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    if name == "embed":
        return (x * 0.02).to(dtype)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return (x * (1.0 / math.sqrt(max(fan_in, 1)))).to(dtype)


def init_params(cfg: ModelConfig, generator: torch.Generator) -> Dict:
    """Random weights on the generator's device. The distributions are the
    reference's; the bits are not (a ``torch.Generator`` is not a JAX key).
    """
    dtype = torch_dtype(cfg.param_dtype)

    def build(shapes: Dict) -> Dict:
        return {k: build(v) if isinstance(v, dict) else _init_leaf(generator, k, v, dtype)
                for k, v in sorted(shapes.items())}

    return build(param_shapes(cfg))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _positions(batch: Dict, b: int, s: int, device) -> torch.Tensor:
    if "positions" in batch:
        return batch["positions"]
    return torch.arange(s, dtype=torch.int32, device=device)[None, :].expand(b, s)


def _block_train(cfg: ModelConfig, p: Dict, x, kind: int, positions):
    h = rms_norm(x, p["pre_norm"], cfg.norm_eps)
    if cfg.family == "ssm":
        x = x + ssm_lib.ssm_mixer_train(cfg, p["ssm"], h)
    else:
        x = x + attention_train(cfg, p, h, kind, positions)
    if cfg.d_ff > 0:
        h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
        x = x + swiglu_mlp(p, h)
    return x


def _run_blocks(cfg: ModelConfig, blocks: Dict, x, kinds, positions):
    for i, kind in enumerate(kinds):
        x = _block_train(cfg, tree_map(lambda v: v[i], blocks), x, kind, positions)
    return x


def forward(cfg: ModelConfig, params: Dict, batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (b, s, V), moe_aux_loss) — aux is 0 for the ported
    families (no MoE)."""
    _require_ported(cfg)
    x = embed_tokens(params["embed"], batch["tokens"], torch_dtype(cfg.compute_dtype))
    b, s = x.shape[0], x.shape[1]
    positions = _positions(batch, b, s, x.device)
    x = _run_blocks(cfg, params["blocks"], x, cfg.layer_kinds(), positions)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return lm_head_logits(cfg, params, x), aux


def loss_fn(cfg: ModelConfig, params: Dict, batch: Dict) -> Tuple[torch.Tensor, Dict]:
    logits, aux = forward(cfg, params, batch)
    ce = cross_entropy_loss(logits, batch["labels"], batch.get("mask"))
    preds = torch.argmax(logits, dim=-1)
    acc = torch.mean((preds == batch["labels"]).to(torch.float32))
    return ce, {"ce": ce, "moe_aux": aux, "acc": acc}


# ---------------------------------------------------------------------------
# Stage partitioning (consumed by the Ferret pipeline engine)
# ---------------------------------------------------------------------------


def split_stage_params(cfg: ModelConfig, params: Dict, boundaries) -> list:
    """Split into P stage dicts. boundaries = partition scheme L (P+1 ints).

    Stage 0 owns the embedding; the last stage owns final_norm (+ lm_head).
    The stage tensors are views of ``params``.
    """
    P_ = len(boundaries) - 1
    stages = []
    for j in range(P_):
        lo, hi = boundaries[j], boundaries[j + 1]
        sp: Dict = {"blocks": tree_map(lambda v: v[lo:hi], params["blocks"])}
        if j == 0:
            sp["embed"] = params["embed"]
        if j == P_ - 1:
            sp["final_norm"] = params["final_norm"]
            if not cfg.tie_embeddings:
                sp["lm_head"] = params["lm_head"]
        stages.append(sp)
    return stages


def merge_stage_params(cfg: ModelConfig, stages: list) -> Dict:
    """Inverse of split_stage_params."""
    blocks = tree_map(lambda *vs: torch.cat(vs, dim=0), *(s["blocks"] for s in stages))
    params = {"embed": stages[0]["embed"], "blocks": blocks, "final_norm": stages[-1]["final_norm"]}
    if "lm_head" in stages[-1]:
        params["lm_head"] = stages[-1]["lm_head"]
    return params


def stage_forward(
    cfg: ModelConfig,
    stage_params: Dict,
    x,
    stage_idx: int,
    num_stages: int,
    boundaries,
    batch: Dict,
):
    """Forward one pipeline stage. Stage 0 embeds the batch's tokens; later
    stages receive activations. The last stage returns logits."""
    _require_ported(cfg)
    lo, hi = boundaries[stage_idx], boundaries[stage_idx + 1]
    if stage_idx == 0:
        x = embed_tokens(
            stage_params["embed"], batch["tokens"], torch_dtype(cfg.compute_dtype)
        )
    b, s = x.shape[0], x.shape[1]
    positions = _positions(batch, b, s, x.device)
    x = _run_blocks(cfg, stage_params["blocks"], x, cfg.layer_kinds()[lo:hi], positions)
    if stage_idx == num_stages - 1:
        x = rms_norm(x, stage_params["final_norm"], cfg.norm_eps)
        return lm_head_logits(cfg, stage_params, x)
    return x
