"""The port's dense decoder vs ``repro.models`` on the same bridged weights.

Smoke config of h2o-danube-1.8b in float32 on the CPU. Tolerances: layer
outputs within 1e-5 and logits within 2e-4 (fp32; matrix products sum in
another order in XLA than in PyTorch); gradients within 1e-4 of the
largest gradient of their leaf.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke_cfg
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.bridge import params_from_numpy, to_numpy
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_config


def _cfgs(**overrides):
    """The same smoke config in both packages (f32 compute)."""
    jcfg = smoke_cfg("h2o-danube-1.8b", **overrides)
    cfg = dataclasses.replace(get_config("h2o-danube-1.8b", smoke=True),
                              compute_dtype="float32", **overrides)
    return jcfg, cfg


def _batch(vocab, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, size=(b, s)).astype(np.int32),
            "labels": rng.integers(0, vocab, size=(b, s)).astype(np.int32)}


def _both(np_tree):
    return jax.tree.map(jnp.asarray, np_tree), params_from_numpy(np_tree)


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = _cfgs(num_layers=4)
    np_params = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, cfg, np_params


def test_registry_config_matches_reference():
    from repro.models.registry import get_config as jget

    for arch in ("h2o-danube-1.8b", "mamba2-780m"):
        for smoke in (False, True):
            assert dataclasses.asdict(get_config(arch, smoke=smoke)) == \
                dataclasses.asdict(jget(arch, smoke=smoke))
    with pytest.raises(ValueError, match="not ported"):
        get_config("hymba-1.5b")


def test_init_params_layout_matches_reference(model):
    jcfg, cfg, np_params = model
    mine = T.init_params(cfg, torch.Generator().manual_seed(0))
    flat_mine = jax.tree_util.tree_flatten_with_path(to_numpy(mine))[0]
    flat_ref = jax.tree_util.tree_flatten_with_path(np_params)[0]
    assert [p for p, _ in flat_mine] == [p for p, _ in flat_ref]
    for (path, a), (_, b) in zip(flat_mine, flat_ref):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if "norm" in str(path[-1]):
            assert not a.any()
        else:  # same fan-in scaled distribution (bits differ by design)
            assert np.std(a) == pytest.approx(np.std(b), rel=0.25), path


LAYER_CASES = ["rms_norm", "apply_rope", "causal_mask_bias", "gqa", "attention_train",
               "swiglu_mlp", "embed_tokens", "cross_entropy_loss"]


@pytest.mark.parametrize("case", LAYER_CASES)
def test_layer_matches_reference(model, case):
    jcfg, cfg, np_params = model
    rng = np.random.default_rng(1)
    blk = {k: v[1] for k, v in np_params["blocks"].items()}
    jblk, tblk = _both(blk)
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    if case == "rms_norm":
        w = rng.normal(size=cfg.d_model).astype(np.float32)
        got = L.rms_norm(torch.from_numpy(x), torch.from_numpy(w), cfg.norm_eps)
        want = JL.rms_norm(jnp.asarray(x), jnp.asarray(w), cfg.norm_eps)
    elif case == "apply_rope":
        q = rng.normal(size=(2, 12, 4, 16)).astype(np.float32)
        got = L.apply_rope(torch.from_numpy(q), torch.from_numpy(pos), 10_000.0)
        want = JL.apply_rope(jnp.asarray(q), jnp.asarray(pos), 10_000.0)
    elif case == "causal_mask_bias":
        for window in (None, 5):
            np.testing.assert_array_equal(L.causal_mask_bias(12, window, "cpu").numpy(),
                                          np.asarray(JL.causal_mask_bias(12, window)))
        return
    elif case == "gqa":
        q = rng.normal(size=(2, 12, 4, 16)).astype(np.float32)
        k = rng.normal(size=(2, 12, 2, 16)).astype(np.float32)
        v = rng.normal(size=(2, 12, 2, 16)).astype(np.float32)
        got = L.gqa_scores_softmax_value(*map(torch.from_numpy, (q, k, v)),
                                         L.causal_mask_bias(12, 8, "cpu"))
        want = JL.gqa_scores_softmax_value(*map(jnp.asarray, (q, k, v)),
                                           JL.causal_mask_bias(12, 8))
    elif case == "attention_train":
        got = L.attention_train(cfg, tblk, torch.from_numpy(x), 1, torch.from_numpy(pos))
        want = JL.attention_train(jcfg, jblk, jnp.asarray(x), jnp.int32(1), jnp.asarray(pos))
    elif case == "swiglu_mlp":
        got = L.swiglu_mlp(tblk, torch.from_numpy(x))
        want = JL.swiglu_mlp(jblk, jnp.asarray(x))
    elif case == "embed_tokens":
        tok = rng.integers(0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
        got = L.embed_tokens(torch.tensor(np_params["embed"]), torch.from_numpy(tok),
                             torch.float32)
        want = JL.embed_tokens(jnp.asarray(np_params["embed"]), jnp.asarray(tok), jnp.float32)
    else:
        logits = rng.normal(size=(2, 12, 50)).astype(np.float32)
        labels = rng.integers(0, 50, size=(2, 12)).astype(np.int32)
        mask = (rng.random((2, 12)) > 0.3).astype(np.float32)
        for m in (None, mask):
            got = L.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                       None if m is None else torch.from_numpy(m))
            want = JL.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                         None if m is None else jnp.asarray(m))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_forward_logits_match_reference(model):
    jcfg, cfg, np_params = model
    jp, tp = _both(np_params)
    batch = _batch(cfg.vocab_size)
    got, aux = T.forward(cfg, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    want, _ = JT.forward(jcfg, jp, {k: jnp.asarray(v) for k, v in batch.items()})
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-4, rtol=0)


def test_loss_and_grads_match_value_and_grad(model):
    jcfg, cfg, np_params = model
    jp, tp = _both(np_params)
    batch = _batch(cfg.vocab_size, seed=3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: JT.loss_fn(jcfg, p, jb), has_aux=True)(jp)
    for v in jax.tree.leaves(tp):
        v.requires_grad_(True)
    loss, met = T.loss_fn(cfg, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert float(met["acc"]) == pytest.approx(float(jmet["acc"]), abs=1.0 / 32)
    flat_t = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.grad.numpy(), tp, is_leaf=torch.is_tensor))[0]
    flat_j = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jgrads))[0]
    for (path, a), (_, b) in zip(flat_t, flat_j):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max() + 1e-12,
                                   err_msg=str(path))


@pytest.mark.parametrize("bounds", [(0, 4), (0, 1, 4), (0, 1, 2, 3, 4), (0, 2, 3, 4)])
def test_stage_forward_composes_to_forward(model, bounds):
    jcfg, cfg, np_params = model
    tp = params_from_numpy(np_params)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab_size, seed=4).items()}
    full, _ = T.forward(cfg, tp, batch)
    stages = T.split_stage_params(cfg, tp, list(bounds))
    x = None
    for j in range(len(bounds) - 1):
        x = T.stage_forward(cfg, stages[j], x, j, len(bounds) - 1, list(bounds), batch)
    np.testing.assert_array_equal(x.detach().numpy(), full.detach().numpy())


def test_stage_split_merge_roundtrip_matches_reference(model):
    jcfg, cfg, np_params = model
    jp, tp = _both(np_params)
    bounds = [0, 1, 3, 4]
    stages = T.split_stage_params(cfg, tp, bounds)
    jstages = JT.split_stage_params(jcfg, jp, bounds)
    for s, js in zip(stages, jstages):
        assert jax.tree.structure(jax.tree.map(np.asarray, js)) == \
            jax.tree.structure(to_numpy(s))
    merged = to_numpy(T.merge_stage_params(cfg, stages))
    for a, b in zip(jax.tree.leaves(merged), jax.tree.leaves(np_params)):
        np.testing.assert_array_equal(a, b)


def test_long_sequences_and_other_families_raise():
    _, cfg = _cfgs()
    tp = T.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.zeros((1, L.BLOCKED_ATTN_THRESHOLD), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="later slice"):
        T.forward(cfg, tp, {"tokens": tokens})
    with pytest.raises(NotImplementedError, match="not ported"):
        T.param_shapes(dataclasses.replace(cfg, family="hybrid"))
