"""Entry points over the kernels: the SSD scan, and the tree-level
Iter-Fisher pack → one kernel → unpack.

The counterpart of ``repro.kernels.ops`` (``ssd_scan``,
``iter_fisher_compensate_tree``, ``iter_fisher_stats_tree``), always on the
kernel path the JAX package takes on its TPU (flat-packed Iter-Fisher).
The kernel wrappers pick the CUDA kernel or the plain version from the
device the tensors are on.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import packing
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.tree import tree_leaves


def ssd_scan(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable SSD scan over any length: a ragged tail is padded to
    a chunk multiple with dt = 0 (decay e^0 = 1, increment 0: the state is
    unchanged), outside the autograd Function, so the gradient drops the pad."""
    slen = x.shape[1]
    pad = (-slen) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    y, state = _ssd.SSDScan.apply(x, dt, A, B, C, initial_state, chunk)
    return (y[:, :slen] if pad else y), state


def iter_fisher_compensate_tree(grad: Any, deltas: Any, lam: torch.Tensor) -> Any:
    """Whole-tree compensation; deltas per leaf ``(τ, *leaf.shape)``, oldest
    first. One kernel launch regardless of leaf count."""
    leaves_d = tree_leaves(deltas)
    tau = leaves_d[0].shape[0] if leaves_d else 0
    if tau == 0:
        return grad
    spec = packing.pack_spec(grad)
    gflat = packing.pack(spec, grad)
    dflat = packing.pack(spec, deltas, lead=1)
    return packing.unpack(spec, packing.compensate_packed(gflat, dflat, lam))


def iter_fisher_stats_tree(
    grad: Any, delta: Any, v_r: Any, v_a: Any, alpha: float
) -> Tuple[Any, Any, torch.Tensor, torch.Tensor]:
    """Whole-tree λ-statistics: (v_r', v_a', Σ s1, Σ s2), one launch; s1 and
    s2 stay 0-d tensors on the device."""
    spec = packing.pack_spec(grad)
    nvr, nva, s1, s2 = packing.stats_packed(
        packing.pack(spec, grad), packing.pack(spec, delta),
        packing.pack(spec, v_r), packing.pack(spec, v_a), alpha,
    )
    vr_dtypes = tuple(leaf.dtype for leaf in tree_leaves(v_r))
    va_dtypes = tuple(leaf.dtype for leaf in tree_leaves(v_a))
    return packing.unpack(spec, nvr, vr_dtypes), packing.unpack(spec, nva, va_dtypes), s1, s2
