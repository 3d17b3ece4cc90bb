"""Flat-packed Iter-Fisher kernels: one launch per compensation step.

``PackSpec`` lays a whole parameter tree out in one contiguous fp32 buffer,
exactly as ``repro.kernels.packing.PackSpec`` does: each leaf starts at an
8·128-aligned offset, the buffer length is a multiple of ``BLOCK``, and the
gaps are zeros. Zero is the identity for every Iter-Fisher quantity
(Δθ = 0 ⇒ no compensation; g = v_r = v_a = 0 ⇒ no statistics), so padding
never leaks into results. Keeping the reference's alignment makes the two
layouts compare one to one.

``compensate_packed`` and ``stats_packed`` are the wrappers of the CUDA
kernels in ``repro_torch/csrc/iter_fisher.cu``. A tensor on the CPU goes to
the plain version in ``kernels/ref.py``; a CUDA tensor launches the kernel
or raises. ``LAUNCHES`` counts kernel launches (CUDA only), so a run can
show that its main path went through the kernels.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

ALIGN = 8 * 128  # leaf slot alignment of the reference layout
BLOCK = 4096  # buffer length multiple of the reference layout

# Kernel launches by wrapper name: bumped once per CUDA launch and nowhere
# else (the CPU path is not a launch).
LAUNCHES: Dict[str, int] = {"compensate_packed": 0, "stats_packed": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Packing layout
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PackSpec:
    """Flat layout of one tree: leaf i occupies ``[offsets[i],
    offsets[i] + sizes[i])`` of a ``(total,)`` fp32 buffer; the tail of its
    ALIGN-rounded slot (and of the BLOCK-rounded buffer) is zero padding."""

    treedef: Any
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    offsets: Tuple[int, ...]
    sizes: Tuple[int, ...]
    slots: Tuple[int, ...]  # ALIGN-rounded width of each leaf's slot
    total: int  # BLOCK-multiple buffer length


def pack_spec(tree: Any) -> PackSpec:
    """The flat layout for ``tree``'s structure and leaf shapes."""
    leaves, treedef = tree_flatten(tree)
    shapes = tuple(tuple(leaf.shape) for leaf in leaves)
    sizes = tuple(math.prod(shape) for shape in shapes)
    slots = tuple(max(_round_up(size, ALIGN), ALIGN) for size in sizes)
    offsets = tuple(sum(slots[:i]) for i in range(len(slots)))
    return PackSpec(
        treedef=treedef,
        shapes=shapes,
        dtypes=tuple(leaf.dtype for leaf in leaves),
        offsets=offsets,
        sizes=sizes,
        slots=slots,
        total=max(_round_up(sum(slots), BLOCK), BLOCK),
    )


def pack(spec: PackSpec, tree: Any, lead: int = 0) -> torch.Tensor:
    """Pack ``tree`` into a ``(*lead_dims, total)`` fp32 buffer.

    ``lead`` leading axes of every leaf (e.g. the stacked-Δθ axis) are kept;
    the remaining axes flatten into the leaf's slot. Gaps are zeros.
    """
    leaves = tree_leaves(tree)
    lead_shape = tuple(leaves[0].shape[:lead])
    out = torch.zeros(lead_shape + (spec.total,), dtype=torch.float32, device=leaves[0].device)
    for leaf, off, size in zip(leaves, spec.offsets, spec.sizes):
        out[..., off:off + size] = leaf.reshape(lead_shape + (size,))
    return out


def unpack(
    spec: PackSpec, flat: torch.Tensor, dtypes: Optional[Tuple[torch.dtype, ...]] = None
) -> Any:
    """Invert ``pack`` for a ``(total,)`` buffer (casts back per leaf)."""
    dtypes = dtypes or spec.dtypes
    leaves = [
        flat[off:off + size].reshape(shape).to(dtype)
        for off, size, shape, dtype in zip(spec.offsets, spec.sizes, spec.shapes, dtypes)
    ]
    return tree_unflatten(spec.treedef, leaves)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on the CPU (the plain-version path); False
    when every one is on one CUDA device; raises on anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}: pass CPU or CUDA tensors")
    return False


def _check_flat(name: str, t: torch.Tensor, shape: Tuple[int, ...]) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned for float4 access")


def _check_total(total: int) -> None:
    if total <= 0 or total % 4 or total >= 2**31:
        raise ValueError(f"packed length {total} must be a positive multiple of 4 below 2**31")


def compensate_packed(
    gflat: torch.Tensor, dflat: torch.Tensor, lam: torch.Tensor
) -> torch.Tensor:
    """Eq. 9 over the packed buffer: one launch for the whole tree.

    gflat ``(total,)`` f32; dflat ``(τ, total)`` f32, oldest first; lam a
    one-element f32 tensor on the same device (never a host float).
    """
    if _on_cpu(gflat, dflat, lam):
        return _ref.compensate_packed_ref(gflat, dflat, lam)
    total = gflat.shape[0]
    tau = dflat.shape[0]
    _check_total(total)
    _check_flat("gflat", gflat, (total,))
    _check_flat("dflat", dflat, (tau, total))
    if lam.dtype != torch.float32 or lam.numel() != 1:
        raise TypeError(f"lam must be one float32 element, got {lam.dtype} {tuple(lam.shape)}")
    if tau == 0:
        return gflat
    from repro_torch.kernels import _build

    lib = _build.library()
    lam = lam.contiguous()
    out = torch.empty_like(gflat)
    with torch.cuda.device(gflat.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ferret_compensate_packed(
            gflat.data_ptr(), dflat.data_ptr(), lam.data_ptr(), out.data_ptr(),
            total, tau, stream,
        )
    _build.check(rc, "compensate_packed")
    LAUNCHES["compensate_packed"] += 1
    return out


def stats_packed(
    gflat: torch.Tensor,
    dflat: torch.Tensor,
    vrflat: torch.Tensor,
    vaflat: torch.Tensor,
    alpha: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Alg. 1 λ-statistics over the packed buffers. Returns (v_r', v_a', s1,
    s2), s1 and s2 as 0-d f32 tensors on the buffers' device."""
    if _on_cpu(gflat, dflat, vrflat, vaflat):
        return _ref.stats_packed_ref(gflat, dflat, vrflat, vaflat, alpha)
    total = gflat.shape[0]
    _check_total(total)
    for name, t in (("gflat", gflat), ("dflat", dflat), ("vrflat", vrflat), ("vaflat", vaflat)):
        _check_flat(name, t, (total,))
    from repro_torch.kernels import _build

    lib = _build.library()
    new_vr = torch.empty_like(gflat)
    new_va = torch.empty_like(gflat)
    partials = torch.empty(
        lib.ferret_stats_scratch_len(total), dtype=torch.float64, device=gflat.device
    )
    s1 = torch.empty((), dtype=torch.float32, device=gflat.device)
    s2 = torch.empty((), dtype=torch.float32, device=gflat.device)
    with torch.cuda.device(gflat.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ferret_stats_packed(
            gflat.data_ptr(), dflat.data_ptr(), vrflat.data_ptr(), vaflat.data_ptr(),
            new_vr.data_ptr(), new_va.data_ptr(), partials.data_ptr(),
            s1.data_ptr(), s2.data_ptr(), total, alpha, 1.0 - alpha, stream,
        )
    _build.check(rc, "stats_packed")
    LAUNCHES["stats_packed"] += 1
    return new_vr, new_va, s1, s2
