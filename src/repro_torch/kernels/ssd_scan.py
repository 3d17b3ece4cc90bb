"""Mamba-2 SSD chunked scan: CUDA forward and backward kernels.

Counterpart of ``repro.kernels.ssd_scan`` (``ssd_scan_pallas``). The
kernels are in ``repro_torch/csrc/ssd_scan.cu``; their plain versions are
``ssd_scan_fwd_ref`` / ``ssd_scan_bwd_ref`` in ``kernels/ref.py``.

``ssd_scan_fwd`` and ``ssd_scan_bwd`` are the wrappers: tensors on the CPU
go to the plain versions, CUDA tensors launch the kernels or raise.
``SSDScan`` is the ``torch.autograd.Function`` over them (the Pallas kernel
has no VJP; the JAX trainer differentiates ``ssd_scan_ref``, and this is
that gradient). The forward saves the fp32 state before each chunk,
(b, c, h, p, n), for the backward instead of recomputing it.
``LAUNCHES`` counts kernel launches (CUDA only).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.packing import _on_cpu

# Wrapper launches by name: bumped once per CUDA call and nowhere else.
LAUNCHES: Dict[str, int] = {"ssd_scan_fwd": 0, "ssd_scan_bwd": 0}

# Limits of the CUDA kernels' tiles.
MAX_HEADDIM = 64
MAX_STATE = 128
CHUNK_MULTIPLE = 64
MAX_CHUNK = 1024


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(name: str, t: torch.Tensor, shape: Tuple[int, ...], dtypes) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_inputs(x, dt, A, B, C, chunk):
    """Shapes, dtypes, contiguity and the kernels' tile limits; returns the dims."""
    if x.dim() != 4:
        raise ValueError(f"x must be (b, l, h, p), got shape {tuple(x.shape)}")
    b, l, h, p = x.shape
    n = B.shape[-1]
    io = (torch.float32, torch.bfloat16)
    _check("x", x, (b, l, h, p), io)
    _check("dt", dt, (b, l, h), (torch.float32,))
    _check("A", A, (h,), (torch.float32,))
    _check("B", B, (b, l, n), (x.dtype,))
    _check("C", C, (b, l, n), (x.dtype,))
    if chunk % CHUNK_MULTIPLE or not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} must be a multiple of {CHUNK_MULTIPLE} up to {MAX_CHUNK}")
    if l % chunk:
        raise ValueError(f"seq {l} not divisible by chunk {chunk}")
    if not 0 < p <= MAX_HEADDIM or not 0 < n <= MAX_STATE:
        raise ValueError(f"head dim {p} must be ≤ {MAX_HEADDIM} and state {n} ≤ {MAX_STATE}")
    return b, l, h, p, n


def _launch(fn_name: str, *args) -> None:
    from repro_torch.kernels import _build

    lib = _build.library()
    rc = getattr(lib, fn_name)(*args, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, fn_name)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _workspace(dims, chunk: int, backward: bool, device) -> torch.Tensor:
    from repro_torch.kernels import _build

    n = _build.library().ferret_ssd_workspace_len(*dims, chunk, int(backward))
    return torch.empty(n, dtype=torch.float32, device=device)


def ssd_scan_fwd(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y in x's dtype, final state f32, state before each chunk f32)."""
    tensors = (x, dt, A, B, C) + (() if initial_state is None else (initial_state,))
    if _on_cpu(*tensors):
        return _ref.ssd_scan_fwd_ref(x, dt, A, B, C, chunk, initial_state)
    b, l, h, p, n = _check_inputs(x, dt, A, B, C, chunk)
    if initial_state is not None:
        _check("initial_state", initial_state, (b, h, p, n), (torch.float32,))
    y = torch.empty_like(x)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    states_before = torch.empty((b, l // chunk, h, p, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        work = _workspace((b, l, h, p, n), chunk, False, x.device)
        _launch("ferret_ssd_fwd", int(x.dtype == torch.bfloat16),
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
                _ptr(initial_state), y.data_ptr(), final.data_ptr(), states_before.data_ptr(),
                work.data_ptr(), b, l, h, p, n, chunk)
    LAUNCHES["ssd_scan_fwd"] += 1
    return y, final, states_before


def ssd_scan_bwd(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    chunk: int,
    states_before: torch.Tensor,
    dy: torch.Tensor,
    dfinal: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """(dx, ddt, dA, dB, dC, ds0): dx, dB, dC in x's dtype, the rest f32."""
    tensors = (x, dt, A, B, C, states_before, dy) + (() if dfinal is None else (dfinal,))
    if _on_cpu(*tensors):
        return _ref.ssd_scan_bwd_ref(x, dt, A, B, C, chunk, states_before, dy, dfinal)
    b, l, h, p, n = _check_inputs(x, dt, A, B, C, chunk)
    _check("states_before", states_before, (b, l // chunk, h, p, n), (torch.float32,))
    _check("dy", dy, (b, l, h, p), (x.dtype,))
    if dfinal is not None:
        _check("dfinal", dfinal, (b, h, p, n), (torch.float32,))
    dx = torch.empty_like(x)
    dB = torch.empty_like(B)
    dC = torch.empty_like(C)
    ddt = torch.empty_like(dt)
    dA = torch.empty_like(A)
    ds0 = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        work = _workspace((b, l, h, p, n), chunk, True, x.device)
        _launch("ferret_ssd_bwd", int(x.dtype == torch.bfloat16),
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
                states_before.data_ptr(), dy.data_ptr(), _ptr(dfinal),
                dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
                ds0.data_ptr(), work.data_ptr(), b, l, h, p, n, chunk)
    LAUNCHES["ssd_scan_bwd"] += 1
    return dx, ddt, dA, dB, dC, ds0


class SSDScan(torch.autograd.Function):
    """(y, final_state) = SSD scan of (x, dt, A, B, C[, s0]); the backward
    is ``ssd_scan_bwd`` (a kernel on the card, the formulas on the CPU)."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, initial_state, chunk):
        y, final, states_before = ssd_scan_fwd(x, dt, A, B, C, chunk, initial_state)
        ctx.save_for_backward(x, dt, A, B, C, states_before)
        ctx.chunk = chunk
        ctx.s0_dtype = None if initial_state is None else initial_state.dtype
        ctx.set_materialize_grads(False)  # an unused final state seeds nothing
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, A, B, C, states_before = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.to(x.dtype).contiguous()
        if dfinal is not None:
            dfinal = dfinal.to(torch.float32).contiguous()
        dx, ddt, dA, dB, dC, ds0 = ssd_scan_bwd(
            x, dt, A, B, C, ctx.chunk, states_before, dy, dfinal)
        ds0 = None if ctx.s0_dtype is None else ds0.to(ctx.s0_dtype)
        return dx, ddt, dA, dB, dC, ds0, None
