"""Gradient compensation for stale gradients (paper §5.1.2, Alg. 1).

Counterpart of ``repro.core.compensation``. The flagship algorithm is
**Iter-Fisher**: iterative first-order Taylor compensation with a
diagonal-Fisher Hessian proxy and an online-optimized global λ
(Eq. 8–12). Baselines from Table 4 are included:

- ``none``        : use the stale gradient as-is (zero-order)
- ``step_aware``  : shrink the step by 1/(τ+1)            [33, 41]
- ``gap_aware``   : per-parameter penalty by the weight gap [7]
- ``fisher``      : one-shot Fisher compensation with the *total* Δθ [14, 85]
- ``iter_fisher`` : Alg. 1 (ours)

All functions operate on nested tensor dicts. The Iter-Fisher hot loops go
through the packed kernels (``repro_torch.kernels.ops``); λ, s1 and s2 stay
0-d tensors on the device, so nothing here waits for the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.tree import tree_leaves, tree_map

Tree = Any
f32 = torch.float32


@dataclasses.dataclass
class CompensationState:
    """λ and its EMA statistics (paper: v_r, v_a; space 2·Σ|w|)."""

    lam: torch.Tensor  # 0-d float32 on the device
    v_r: Tree  # EMA of gradients       (E_k ∇L)
    v_a: Tree  # EMA of g⊙g⊙Δθ          (the λ-feature F)
    steps: torch.Tensor  # 0-d int32 on the device


@dataclasses.dataclass(frozen=True)
class CompensationConfig:
    method: str = "iter_fisher"  # none|step_aware|gap_aware|fisher|iter_fisher
    lam0: float = 0.2  # paper §12: λ = 0.2
    alpha: float = 0.9  # EMA coefficient
    eta_lambda: float = 1e-3  # λ learning rate (0 disables auto-tuning: fixed λ)
    nu: float = 2e-6  # ℓ2 regularizer on λ (paper's μ)


def init_state(params: Tree, cfg: CompensationConfig) -> CompensationState:
    device = tree_leaves(params)[0].device
    if cfg.eta_lambda == 0.0:
        # Fixed-λ mode (paper: η_λ = 0 frees v_r/v_a) — keep empty leaves.
        def zeros(p):
            return torch.zeros((0,), dtype=f32, device=device)
    else:
        def zeros(p):
            return torch.zeros_like(p, dtype=f32)
    return CompensationState(
        lam=torch.full((), cfg.lam0, dtype=f32, device=device),
        v_r=tree_map(zeros, params),
        v_a=tree_map(zeros, params),
        steps=torch.zeros((), dtype=torch.int32, device=device),
    )


# ---------------------------------------------------------------------------
# Iter-Fisher (Alg. 1)
# ---------------------------------------------------------------------------


def _update_lambda(
    state: CompensationState, grad: Tree, first_delta: Tree, cfg: CompensationConfig
) -> CompensationState:
    """Alg. 1 lines 3–7: one λ-descent step + EMA updates (global λ), with
    the whole tree in one packed statistics pass."""
    new_vr, new_va, s1_total, s2_total = ops.iter_fisher_stats_tree(
        grad, first_delta, state.v_r, state.v_a, cfg.alpha
    )
    grad_lam = -2.0 * s1_total + 2.0 * state.lam * s2_total + 2.0 * cfg.nu * state.lam
    new_lam = state.lam - cfg.eta_lambda * grad_lam
    return CompensationState(lam=new_lam, v_r=new_vr, v_a=new_va, steps=state.steps + 1)


def compensate(
    cfg: CompensationConfig,
    state: CompensationState,
    grad: Tree,
    deltas: Tree,  # stacked (K, ...) per leaf: θ^{t+i} − θ^{t+i-1}, oldest first
    lr: float = 1e-3,
    tau: Optional[torch.Tensor] = None,  # staleness on the device; default: K
) -> Tuple[CompensationState, Tree]:
    """Compensate a gradient that is ≤ K versions stale.

    The stacked ``deltas`` axis is oldest→newest; entries beyond the true
    staleness must be zero (a zero Δθ is the identity for every method
    except step_aware, which takes ``tau`` explicitly).
    Returns (new_state, compensated_grad). K = 0 is a no-op.
    """
    method = cfg.method
    leaves_d = tree_leaves(deltas)
    K = leaves_d[0].shape[0] if leaves_d else 0

    if method == "none" or K == 0:
        return state, grad

    if method == "step_aware":
        if tau is None:
            scale = 1.0 / (1.0 + float(K))
        else:
            scale = 1.0 / (1.0 + tau.to(f32))
        return state, tree_map(lambda g: (g * scale).to(g.dtype), grad)

    if method == "gap_aware":
        # Barkai et al.: divide by the per-parameter gap 1 + |Δθ_total| / η.
        def leaf(g, d):
            total = torch.sum(d.to(f32), dim=0)
            gap = 1.0 + torch.abs(total) / max(lr, 1e-12)
            return (g.to(f32) / gap).to(g.dtype)

        return state, tree_map(leaf, grad, deltas)

    if method == "fisher":
        # One-shot: g + λ g⊙g⊙(θ^{t+τ} − θ^t); fixed λ, no iteration, no tuning.
        def leaf(g, d):
            total = torch.sum(d.to(f32), dim=0)
            g32 = g.to(f32)
            return (g32 + cfg.lam0 * g32 * g32 * total).to(g.dtype)

        return state, tree_map(leaf, grad, deltas)

    if method == "iter_fisher":
        if cfg.eta_lambda > 0.0:
            # Alg. 1 lines 3–7 use the most recent version step (θ^t − θ^{t-1}).
            last_delta = tree_map(lambda d: d[-1], deltas)
            state = _update_lambda(state, grad, last_delta, cfg)
        return state, ops.iter_fisher_compensate_tree(grad, deltas, state.lam)

    raise ValueError(f"unknown compensation method {method!r}")
