"""Plain PyTorch versions of the port's CUDA kernels.

These carry the reference semantics of ``repro.kernels.ref``:
- ``compensate_packed_ref`` / ``stats_packed_ref``: Iter-Fisher
  (``iter_fisher_compensate_ref`` / ``iter_fisher_leaf_stats_ref``) over
  the flat packed fp32 buffers of ``repro_torch.kernels.packing``. Every
  elementwise step rounds to fp32 in the same order as the kernels do.
- ``ssd_scan_ref`` / ``ssd_scan_bwd_ref``: the Mamba-2 SSD chunked scan
  (``repro.kernels.ref.ssd_scan_ref``) and its gradient, written out as
  formulas (not autograd) so the CPU tests check the math the CUDA
  backward implements.
The kernel wrappers run them for tensors on the CPU; the tests and
``chip_smoke.py`` hold the CUDA kernels against them.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


# ---------------------------------------------------------------------------
# Mamba-2 SSD chunked scan (state-space duality)
#
# Per batch, chunk c of Q tokens and head h, with a = dt·A and
# cs = cumsum(a) inside the chunk:
#   L[l,s]   = exp(cs_l − cs_s) for s ≤ l, else 0 (masked with −inf before
#              the exp, so no inf·0 ever forms)
#   y_diag   = ((C·Bᵀ) ⊙ L ⊙ dt_s) · x
#   state_c  = Σ_s dt_s·exp(cs_end − cs_s) · x_s ⊗ B_s
#   S_{c+1}  = exp(cs_end)·S_c + state_c      (S_0 = s0; final = S_nc)
#   y_off[l] = exp(cs_l) · (C_l · S_cᵀ)
# Every contraction is staged (G = C·Bᵀ, then W = G⊙L⊙dt, then W·x): one
# five-operand einsum may pick an order that materialises (b,c,Q,Q,h,p).
# ---------------------------------------------------------------------------


def _ssd_chunks(x, dt, A, B, C, chunk):
    """The per-chunk f32 pieces both directions share."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    if l % chunk:
        raise ValueError(f"seq {l} not divisible by chunk {chunk}")
    c = l // chunk
    f32 = torch.float32
    xh = x.reshape(b, c, chunk, h, p).to(f32).permute(0, 1, 3, 2, 4)  # (b,c,h,Q,p)
    dth = dt.reshape(b, c, chunk, h).to(f32).permute(0, 1, 3, 2)  # (b,c,h,Q)
    Bc = B.reshape(b, c, chunk, n).to(f32)  # (b,c,Q,n)
    Cc = C.reshape(b, c, chunk, n).to(f32)
    cs = torch.cumsum(dth * A.to(f32)[:, None], dim=-1)  # (b,c,h,Q) inclusive
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    diff = cs[..., :, None] - cs[..., None, :]  # cs_l − cs_s
    Lmat = torch.exp(torch.where(causal, diff, -torch.inf))  # (b,c,h,l,s)
    G = Cc @ Bc.transpose(-1, -2)  # (b,c,l,s), the same for every head
    W = G[:, :, None] * Lmat * dth[..., None, :]  # (b,c,h,l,s)
    decay_end = torch.exp(cs[..., -1:] - cs)  # (b,c,h,Q)
    u = dth * decay_end
    return xh, dth, Bc, Cc, cs, Lmat, G, W, decay_end, u


def ssd_scan_fwd_ref(
    x: torch.Tensor,  # (b, l, h, p)
    dt: torch.Tensor,  # (b, l, h) positive (softplus applied)
    A: torch.Tensor,  # (h,) negative
    B: torch.Tensor,  # (b, l, n)
    C: torch.Tensor,  # (b, l, n)
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,  # (b, h, p, n)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y (b,l,h,p) in x's dtype, final state (b,h,p,n) f32, the state
    before each chunk (b,c,h,p,n) f32, which the backward reads)."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    xh, dth, Bc, Cc, cs, Lmat, G, W, decay_end, u = _ssd_chunks(x, dt, A, B, C, chunk)
    y_diag = W @ xh  # (b,c,h,l,p)
    chunk_states = (xh * u[..., None]).transpose(-1, -2) @ Bc[:, :, None]  # (b,c,h,p,n)
    chunk_decay = torch.exp(cs[..., -1])  # (b,c,h)
    s = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.to(torch.float32))
    before = []
    for ci in range(chunk_states.shape[1]):
        before.append(s)
        s = s * chunk_decay[:, ci, :, None, None] + chunk_states[:, ci]
    states_before = torch.stack(before, dim=1)
    y_off = (Cc[:, :, None] @ states_before.transpose(-1, -2)) * torch.exp(cs)[..., None]
    y = (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(b, l, h, p)
    return y.to(x.dtype), s, states_before


def ssd_scan_ref(x, dt, A, B, C, chunk, initial_state=None):
    """Chunked SSD scan (Mamba-2): (y (b,l,h,p), final_state (b,h,p,n) f32).

    Semantics: s_t = exp(dt_t A) s_{t-1} + dt_t B_t x_t ;  y_t = C_t · s_t.
    """
    y, final, _ = ssd_scan_fwd_ref(x, dt, A, B, C, chunk, initial_state)
    return y, final


def ssd_scan_bwd_ref(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    chunk: int,
    states_before: torch.Tensor,  # (b, c, h, p, n) f32, from the forward
    dy: torch.Tensor,  # (b, l, h, p)
    dfinal: Optional[torch.Tensor] = None,  # (b, h, p, n) or None (zero)
) -> Tuple[torch.Tensor, ...]:
    """Gradients (dx, ddt, dA, dB, dC, ds0) of the scan, as formulas.

    The terms, per chunk and head (E = ∂/∂S_{c+1}, from a reverse scan
    over chunks seeded with ``dfinal``):
      y_off : dC += e^{cs}·(dy·S_c);  ∂S_c += (e^{cs}⊙dy)ᵀ·C;
              ∂cs_l += Σ_p dy·y_off
      y_diag: dW = dy·xᵀ; dx += Wᵀ·dy; dG = dW⊙L⊙dt_s → dC += dG·B,
              dB += dGᵀ·C; ∂dt_s += Σ_l dW⊙G⊙L; with M = dW⊙W,
              ∂cs_l += Σ_s M, ∂cs_s −= Σ_l M
      state : dx += u⊙(B·Eᵀ); dB += u⊙(x·E); du = Σ_p x⊙(B·Eᵀ) with
              u = dt·e^{cs_end−cs}: ∂dt += du·e^{cs_end−cs},
              ∂cs_s −= du·u, ∂cs_end += Σ du·u
      decay : ∂cs_end += (Σ E⊙S_c)·e^{cs_end}
    and cs = cumsum(dt·A): ∂a = reverse cumsum of ∂cs, ∂dt += A·∂a,
    dA = Σ dt·∂a. dB and dC sum over heads; dA over batch and positions.
    """
    b, l, h, p = x.shape
    n = B.shape[-1]
    f32 = torch.float32
    xh, dth, Bc, Cc, cs, Lmat, G, W, decay_end, u = _ssd_chunks(x, dt, A, B, C, chunk)
    c = xh.shape[1]
    sb = states_before.to(f32)
    dyh = dy.reshape(b, c, chunk, h, p).to(f32).permute(0, 1, 3, 2, 4)  # (b,c,h,Q,p)
    ecs = torch.exp(cs)
    chunk_decay = ecs[..., -1]

    # y_off
    dC_off = (dyh @ sb) * ecs[..., None]  # (b,c,h,Q,n)
    dsb = (dyh * ecs[..., None]).transpose(-1, -2) @ Cc[:, :, None]  # (b,c,h,p,n)
    dcs = (dC_off * Cc[:, :, None]).sum(-1)

    # reverse scan over the chunk boundaries
    D = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
         if dfinal is None else dfinal.to(f32))
    E, ddecay = [None] * c, [None] * c
    for ci in reversed(range(c)):
        E[ci] = D
        ddecay[ci] = (D * sb[:, ci]).sum((-1, -2))
        D = D * chunk_decay[:, ci, :, None, None] + dsb[:, ci]
    E = torch.stack(E, dim=1)  # (b,c,h,p,n)
    ddecay = torch.stack(ddecay, dim=1)  # (b,c,h)

    # chunk-end states
    BE = Bc[:, :, None] @ E.transpose(-1, -2)  # (b,c,h,Q,p)
    du = (xh * BE).sum(-1)  # (b,c,h,Q)
    dx = u[..., None] * BE
    dB_h = u[..., None] * (xh @ E)  # (b,c,h,Q,n)

    # intra-chunk
    dW = dyh @ xh.transpose(-1, -2)  # (b,c,h,l,s); zero where W is
    dx = dx + W.transpose(-1, -2) @ dyh
    dG = (dW * Lmat * dth[..., None, :]).sum(2)  # summed over heads (b,c,l,s)
    M = dW * W
    dcs = dcs + M.sum(-1) - M.sum(-2)
    ddt = (dW * G[:, :, None] * Lmat).sum(-2) + du * decay_end

    uu = du * u
    dcs = dcs - uu
    dcs[..., -1] += uu.sum(-1) + ddecay * chunk_decay
    da = torch.flip(torch.cumsum(torch.flip(dcs, (-1,)), -1), (-1,))
    ddt = ddt + A.to(f32)[:, None] * da
    dA = (dth * da).sum((0, 1, 3))

    dB = dB_h.sum(2) + dG.transpose(-1, -2) @ Cc
    dC = dC_off.sum(2) + dG @ Bc
    dx = dx.permute(0, 1, 3, 2, 4).reshape(b, l, h, p)
    ddt = ddt.permute(0, 1, 3, 2).reshape(b, l, h)
    return (dx.to(x.dtype), ddt.to(dt.dtype), dA.to(A.dtype),
            dB.reshape(b, l, n).to(B.dtype), dC.reshape(b, l, n).to(C.dtype), D)
