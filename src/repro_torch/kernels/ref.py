"""Plain PyTorch versions of the port's CUDA kernels.

These carry the reference semantics of ``repro.kernels.ref``
(``iter_fisher_compensate_ref`` / ``iter_fisher_leaf_stats_ref``) over the
flat packed fp32 buffers of ``repro_torch.kernels.packing``. The wrappers
in ``packing`` run them for tensors on the CPU; the tests and
``chip_smoke.py`` hold the CUDA kernels against them. Every elementwise
step rounds to fp32 in the same order as the kernels do.
"""

from __future__ import annotations

from typing import Tuple

import torch


def compensate_packed_ref(
    gflat: torch.Tensor, dflat: torch.Tensor, lam: torch.Tensor
) -> torch.Tensor:
    """Eq. 9 with an fp32 carry: ``for i < τ: g ← g + λ·g⊙g⊙Δθ_i``.

    gflat ``(total,)``; dflat ``(τ, total)`` oldest first; lam 0-d or (1,).
    """
    g = gflat.to(torch.float32)
    lam = lam.reshape(()).to(torch.float32)
    for i in range(dflat.shape[0]):
        g = g + lam * g * g * dflat[i].to(torch.float32)
    return g


def stats_packed_ref(
    gflat: torch.Tensor,
    dflat: torch.Tensor,
    vrflat: torch.Tensor,
    vaflat: torch.Tensor,
    alpha: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Alg. 1 λ-statistics (paper Eq. 10–12). Returns (v_r', v_a', s1, s2):

    dv_r = (1-α)(g − v_r)
    s1   = Σ dv_r ⊙ v_a   (old v_a)
    s2   = Σ v_a ⊙ v_a    (old v_a)
    v_r' = α v_r + (1-α) g
    v_a' = α v_a + (1-α) (g ⊙ g ⊙ Δθ)
    """
    f32 = torch.float32
    g, d = gflat.to(f32), dflat.to(f32)
    vr, va = vrflat.to(f32), vaflat.to(f32)
    dv_r = (1.0 - alpha) * (g - vr)
    s1 = torch.sum(dv_r * va)
    s2 = torch.sum(va * va)
    new_vr = alpha * vr + (1.0 - alpha) * g
    new_va = alpha * va + (1.0 - alpha) * (g * g * d)
    return new_vr, new_va, s1, s2
