#!/usr/bin/env python3
"""Run the PyTorch/CUDA port of Ferret end to end on one CUDA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit, then builds the CUDA kernels
   from ``src/repro_torch/csrc`` (nvcc, sm_90a, one process per source).
2. Kernel phases: holds each kernel against its plain PyTorch version on
   the card and times both with CUDA events:
   - Iter-Fisher compensate/stats at the h2o path's shapes (the largest
     stage's packed length and Δθ depth) and on a small ragged tree;
   - the SSD scan forward and backward at the mamba2 path's shapes
     (b 2, l 1024, h 48, p 64, n 128, Q 256; x/B/C bf16, dt/A f32).
3. Path phases: ``FerretTrainer.run_stream``, batch 2, seq 1024,
   Iter-Fisher with λ tuning, 32 rounds in 2 segments, at full width:
   - h2o-danube-1.8b, 4 of its 24 layers;
   - mamba2-780m, 16 of its 48 layers.
   Before each, every kernel's launch count is zeroed; just after, the
   kernels of that path must have run (compensate and stats; on mamba2 also
   the SSD forward and backward).
4. Reference checks: each family's trainer at smoke size on the card and on
   the CPU (plain versions) from the same weights must agree.
5. Prints ``{"kernels": [...]}`` and, as the last line,
   ``{"ok": true, "device": {...}}``.

Any failure exits non-zero. Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense, 700 W): device memory; fp32 outside the
# tensor cores, the type the Iter-Fisher kernels compute in; bf16 in the
# tensor cores, the peak the SSD scan's contractions are held to.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float, peak: float = FP32_FLOPS):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def all_launches() -> dict:
    from repro_torch.kernels import packing, ssd_scan

    return {**packing.LAUNCHES, **ssd_scan.LAUNCHES}


def reset_all_launches() -> None:
    from repro_torch.kernels import packing, ssd_scan

    packing.reset_launches()
    ssd_scan.reset_launches()


def kernel_checks(total: int, tau: int, gen, label: str) -> dict:
    """Kernels vs plain versions on (total,)-long buffers; returns timings
    and errors. Tolerances: the kernels round every elementwise operation
    like the plain versions (rtol 1e-6, expected exact); s1 and s2 are sums
    taken in another order, held to 1e-5 of the sum of |terms|."""
    import torch

    from repro_torch.kernels import packing, ref

    dev = "cuda"
    g = torch.randn(total, generator=gen, device=dev)
    d = torch.randn(tau, total, generator=gen, device=dev) * 0.01
    vr = torch.randn(total, generator=gen, device=dev) * 0.1
    va = torch.randn(total, generator=gen, device=dev) * 0.01
    lam = torch.full((), 0.2, device=dev)
    alpha = 0.9

    out = packing.compensate_packed(g, d, lam)
    want = ref.compensate_packed_ref(g, d, lam)
    err_c = (out - want).abs()
    check(bool((err_c <= 1e-6 * want.abs()).all()),
          f"{label}: compensate_packed disagrees with its plain version (max {err_c.max()})")

    nvr, nva, s1, s2 = packing.stats_packed(g, d[-1], vr, va, alpha)
    wvr, wva, ws1, ws2 = ref.stats_packed_ref(g, d[-1], vr, va, alpha)
    errs = [(nvr - wvr).abs(), (nva - wva).abs()]
    for e, w, name in zip(errs, (wvr, wva), ("v_r'", "v_a'")):
        check(bool((e <= 1e-6 * w.abs()).all()),
              f"{label}: stats_packed {name} disagrees (max {e.max()})")
    s1_scale = ((1.0 - alpha) * (g.double() - vr.double()) * va.double()).abs().sum()
    s2_scale = (va.double() ** 2).sum()
    e1, e2 = (s1 - ws1).abs().double(), (s2 - ws2).abs().double()
    check(bool(e1 <= 1e-5 * s1_scale), f"{label}: s1 {s1.item()} vs {ws1.item()}")
    check(bool(e2 <= 1e-5 * s2_scale), f"{label}: s2 {s2.item()} vs {ws2.item()}")
    torch.cuda.synchronize()
    res = {
        "compensate_packed": {
            "max_abs_err": float(err_c.max()),
            "ms": cuda_ms(lambda: packing.compensate_packed(g, d, lam)),
            "plain_ms": cuda_ms(lambda: ref.compensate_packed_ref(g, d, lam)),
            # read g and τ Δθ rows, write the output; 4 fp32 ops per row
            "bound": bound_ms((2 + tau) * total * 4 + 4, 4.0 * tau * total),
        },
        "stats_packed": {
            "max_abs_err": float(max(errs[0].max(), errs[1].max(), e1, e2)),
            "ms": cuda_ms(lambda: packing.stats_packed(g, d[-1], vr, va, alpha)),
            "plain_ms": cuda_ms(lambda: ref.stats_packed_ref(g, d[-1], vr, va, alpha)),
            # read g, Δθ, v_r, v_a, write v_r', v_a' and two scalars; 14 ops each
            "bound": bound_ms(6 * total * 4 + 8, 14.0 * total),
        },
    }
    for name, r in res.items():
        print(f"[kernel] {label} {name}: total={total} tau={tau} "
              f"max_abs_err={r['max_abs_err']:.3g} ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_us={r['bound'][0] * 1e3:.1f} ({r['bound'][1]})", flush=True)
    return res


def close(got, want, name: str, bf16: bool = False) -> float:
    """The SSD kernels sum in another order than the plain versions: f32
    results within 1e-4 of the largest |value| of their tensor; results both
    write in bf16 also one bf16 rounding (8e-3 relative) apart."""
    import torch

    check(got.dtype == want.dtype and got.shape == want.shape, f"{name}: dtype/shape")
    got, want = got.float(), want.float()
    scale = float(want.abs().max())
    err = (got - want).abs()
    tol = 1e-4 * scale + (8e-3 * want.abs() if bf16 else 0.0)
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite values")
    check(bool((err <= tol).all()), f"{name}: max |err| {float(err.max())} at scale {scale}")
    return float(err.max())


def ssd_checks(cfg, batch: int, seq: int, gen) -> dict:
    """SSD forward/backward kernels vs plain versions at the mamba2 path's
    shapes (bf16 x/B/C, f32 dt/A, as ``ssm_mixer_train`` hands them over)."""
    import torch

    from repro_torch.kernels import ref, ssd_scan

    dev, bf = "cuda", torch.bfloat16
    b, l, h, p, n, Q = batch, seq, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_chunk
    nc = l // Q
    x = torch.randn(b, l, h, p, generator=gen, device=dev).to(bf)
    dt = torch.nn.functional.softplus(torch.randn(b, l, h, generator=gen, device=dev) - 2.0)
    A = -torch.exp(torch.rand(h, generator=gen, device=dev) * 2.7)
    B = (torch.randn(b, l, n, generator=gen, device=dev) / n**0.5).to(bf)
    C = (torch.randn(b, l, n, generator=gen, device=dev) / n**0.5).to(bf)
    dy = torch.randn(b, l, h, p, generator=gen, device=dev).to(bf)

    y, final, sb = ssd_scan.ssd_scan_fwd(x, dt, A, B, C, Q)
    wy, wfinal, wsb = ref.ssd_scan_fwd_ref(x, dt, A, B, C, Q)
    err_f = max(close(y, wy, "ssd y", bf16=True), close(final, wfinal, "ssd final state"),
                close(sb, wsb, "ssd states_before"))
    got = ssd_scan.ssd_scan_bwd(x, dt, A, B, C, Q, wsb, dy)
    want = ref.ssd_scan_bwd_ref(x, dt, A, B, C, Q, wsb, dy)
    err_b = max(close(g, w, f"ssd {name}", bf16=name in ("dx", "dB", "dC"))
                for g, w, name in zip(got, want, ("dx", "ddt", "dA", "dB", "dC", "ds0")))
    torch.cuda.synchronize()
    # the least work of the scan and of its gradient: each input read once,
    # each output written once (the backward reads the saved states); the
    # contractions at the bf16 tensor-core peak, each Q×Q product causal
    # (Q(Q+1)/2 of its Q² entries). B and C have no head axis, so G = C·Bᵀ,
    # dG·B and dGᵀ·C are needed once per (b, chunk), with dG summed over
    # heads; per head and chunk the forward needs W·x and two state
    # products (Q(Q+1)p + 4Qpn), the backward dy·xᵀ, Wᵀ·dy and four state
    # products (2Q(Q+1)p + 8Qpn)
    io = b * l * h * p * 2
    bc = b * l * n * 2
    fwd_bytes = io + b * l * h * 4 + h * 4 + 2 * bc + io + b * h * p * n * 4
    bwd_bytes = (2 * io + b * l * h * 4 + h * 4 + 2 * bc + b * nc * h * p * n * 4
                 + io + b * l * h * 4 + h * 4 + 2 * bc)
    tri = Q * (Q + 1)  # 2 · Q(Q+1)/2: one causal Q×Q product, per unit of its inner dim
    fwd_flops = b * nc * tri * n + b * nc * h * (tri * p + 4 * Q * p * n)
    bwd_flops = b * nc * 3 * tri * n + b * nc * h * (2 * tri * p + 8 * Q * p * n)
    res = {
        "ssd_scan_fwd": {
            "max_abs_err": err_f,
            "ms": cuda_ms(lambda: ssd_scan.ssd_scan_fwd(x, dt, A, B, C, Q)),
            "plain_ms": cuda_ms(lambda: ref.ssd_scan_fwd_ref(x, dt, A, B, C, Q)),
            "bound": bound_ms(fwd_bytes, fwd_flops, BF16_FLOPS),
        },
        "ssd_scan_bwd": {
            "max_abs_err": err_b,
            "ms": cuda_ms(lambda: ssd_scan.ssd_scan_bwd(x, dt, A, B, C, Q, sb, dy)),
            "plain_ms": cuda_ms(lambda: ref.ssd_scan_bwd_ref(x, dt, A, B, C, Q, sb, dy)),
            "bound": bound_ms(bwd_bytes, bwd_flops, BF16_FLOPS),
        },
    }
    for name, r in res.items():
        print(f"[kernel] {name}: b={b} l={l} h={h} p={p} n={n} Q={Q} x/B/C bf16 "
              f"max_abs_err={r['max_abs_err']:.3g} ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_us={r['bound'][0] * 1e3:.1f} ({r['bound'][1]})", flush=True)
    return res


def run_path(cfg, fc, batch: int, seq: int, rounds: int, seg: int, must_launch) -> dict:
    """``FerretTrainer.run_stream`` with every launch count zeroed just
    before and read just after; each kernel in ``must_launch`` must have run."""
    import numpy as np
    import torch

    from repro_torch.core.ferret import FerretTrainer
    from repro_torch.models import transformer as T
    from repro_torch.ocl.streams import StreamConfig, make_stream

    trainer = FerretTrainer(cfg, fc, batch=batch, seq=seq)
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    # token ids from the first 512 of the vocabulary (the Markov source's
    # tables are vocab² floats)
    stream = make_stream(StreamConfig(kind="drift", modality="tokens", length=rounds,
                                      batch=batch, vocab=512, seq=seq, seed=0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    t0 = time.perf_counter()
    res = trainer.run_stream(params, stream, segment_rounds=seg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches()
    check(res.rounds == rounds, f"ran {res.rounds} rounds, expected {rounds}")
    check(bool(np.isfinite(res.losses).all()), f"non-finite losses: {res.losses}")
    check(bool(np.isfinite(res.lam_curve).all()), "non-finite λ")
    for name in must_launch:
        check(launches[name] > 0, f"kernel {name} was not launched on the {cfg.name} path")
    print(f"[path] {cfg.name}: online_acc={res.online_acc:.4f} loss first={res.losses[0]:.4f} "
          f"last={res.losses[-1]:.4f} lam_last={res.lam_curve[-1]:.7f} "
          f"ms_per_round={wall / rounds * 1e3:.1f} (first use included) "
          f"max_memory_allocated={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"launches={launches}", flush=True)
    del params, trainer, res
    torch.cuda.empty_cache()
    return launches


def reference_check(small, fc, lr: float, seq: int, must_launch) -> None:
    """The trainer at smoke size on the card and on the CPU from the same
    weights: fp32 on both; sums run in other orders on the card, and 48
    rounds of Adam carry that drift (the CPU port and the JAX package differ
    by ~3e-5 on the dense run). Losses within 1e-3, λ within 1e-5."""
    import numpy as np
    import torch

    from repro_torch.core.ferret import FerretTrainer
    from repro_torch.models import transformer as T
    from repro_torch.ocl.streams import StreamConfig, make_stream

    sfc = dataclasses.replace(fc, lr=lr)
    sparams = T.init_params(small, torch.Generator().manual_seed(1))
    sstream = make_stream(StreamConfig(kind="iid", modality="tokens", length=48, batch=2,
                                       vocab=32, seq=seq, seed=0))
    reset_all_launches()
    on_card = FerretTrainer(small, sfc, 2, seq).run_stream(sparams, sstream, segment_rounds=16)
    launches = all_launches()
    for name in must_launch:
        check(launches[name] > 0, f"kernel {name} did not run on {small.name}")
    on_cpu = FerretTrainer(small, sfc, 2, seq, device="cpu").run_stream(
        sparams, sstream, segment_rounds=16)
    loss_err = float(np.abs(on_card.losses - on_cpu.losses).max())
    lam_err = float(np.abs(on_card.lam_curve - on_cpu.lam_curve).max())
    check(loss_err <= 1e-3, f"{small.name}: card and CPU losses differ by {loss_err}")
    check(lam_err <= 1e-5, f"{small.name}: card and CPU λ differ by {lam_err}")
    check(abs(on_card.online_acc - on_cpu.online_acc) <= 0.02, "online accuracy differs")
    print(f"[reference] {small.name} trainer card vs CPU (lr {lr}, seq {seq}): max |Δloss|={loss_err:.3g} "
          f"max |Δλ|={lam_err:.3g} online_acc {on_card.online_acc:.4f} vs "
          f"{on_cpu.online_acc:.4f}", flush=True)


def meta_params(shapes):
    """Shape-only tensors (device "meta") for a nested dict of shapes."""
    import torch

    return {k: meta_params(v) if isinstance(v, dict) else torch.empty(v, device="meta")
            for k, v in shapes.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.compensation import CompensationConfig
    from repro_torch.core.ferret import FerretConfig, FerretTrainer
    from repro_torch.core.schedule import ring_geometry
    from repro_torch.kernels import _build, packing
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"[build] {lib_path.name} in {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- the h2o path's configuration ----------------------------------------
    cfg = dataclasses.replace(get_config("h2o-danube-1.8b"), num_layers=4)
    batch, seq, rounds, seg = 2, 1024, 32, 16
    fc = FerretConfig(
        budget_bytes=float("inf"), lr=1e-4, max_workers=3, max_stages=4,
        compensation=CompensationConfig(method="iter_fisher", eta_lambda=1e-4),
    )
    plan = FerretTrainer(cfg, fc, batch=batch, seq=seq).plan
    P = plan.partition.num_stages
    K = ring_geometry(plan.config, P).delta_ring
    totals = [packing.pack_spec(sp).total
              for sp in T.split_stage_params(cfg, meta_params(T.param_shapes(cfg)),
                                             plan.partition.bounds)]
    print(f"[config] {cfg.name}: d_model={cfg.d_model} heads={cfg.num_heads}/{cfg.num_kv_heads} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} window={cfg.window} "
          f"params={cfg.param_dtype} compute={cfg.compute_dtype}", flush=True)
    print(f"[config] reduced: num_layers 24 -> {cfg.num_layers}; batch={batch} seq={seq} "
          f"rounds={rounds} in segments of {seg}", flush=True)
    print(f"[plan] P={P} bounds={list(plan.partition.bounds)} "
          f"tau={[P - 1 - j for j in range(P)]} delta_ring={K} "
          f"workers={len(plan.config.active_workers())} packed_totals={totals}", flush=True)

    # ---- kernel phases ---------------------------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    main = kernel_checks(max(totals), K, gen, "main-path")
    ragged = {"w": torch.empty(33, 17), "b": torch.empty(5), "s": torch.empty(()),
              "d": torch.empty(4097)}
    kernel_checks(packing.pack_spec(ragged).total, 3, gen, "ragged")
    mcfg = dataclasses.replace(get_config("mamba2-780m"), num_layers=16)
    ssd = ssd_checks(mcfg, batch, seq, gen)
    torch.cuda.empty_cache()

    # ---- path phases -------------------------------------------------------------
    iter_fisher = ("compensate_packed", "stats_packed")
    h2o_launches = run_path(cfg, fc, batch, seq, rounds, seg, iter_fisher)
    mplan = FerretTrainer(mcfg, fc, batch=batch, seq=seq).plan
    print(f"[config] {mcfg.name}: d_model={mcfg.d_model} d_inner={mcfg.d_inner} "
          f"ssd_heads={mcfg.ssm_heads}x{mcfg.ssm_headdim} state={mcfg.ssm_state} "
          f"conv={mcfg.ssm_conv} chunk={mcfg.ssm_chunk} vocab={mcfg.vocab_size} "
          f"tied={mcfg.tie_embeddings} params={mcfg.param_dtype} compute={mcfg.compute_dtype} "
          f"param_count={mcfg.param_count()}", flush=True)
    print(f"[config] reduced: num_layers 48 -> {mcfg.num_layers}; batch={batch} seq={seq} "
          f"rounds={rounds} in segments of {seg}", flush=True)
    print(f"[plan] {mcfg.name}: P={mplan.partition.num_stages} "
          f"bounds={list(mplan.partition.bounds)} "
          f"workers={len(mplan.config.active_workers())}", flush=True)
    ssd_names = ("ssd_scan_fwd", "ssd_scan_bwd")
    m_launches = run_path(mcfg, fc, batch, seq, rounds, seg, iter_fisher + ssd_names)

    # ---- reference checks: card vs CPU at smoke size -------------------------------
    small = dataclasses.replace(get_config("h2o-danube-1.8b", smoke=True), num_layers=4,
                                vocab_size=32, compute_dtype="float32")
    reference_check(small, fc, 5e-3, 16, iter_fisher)
    # the mamba2 smoke config with a chunk the SSD kernels take (a multiple
    # of 64) at seq 128, two chunks, so the state carried across chunks is
    # held against the CPU inside a trained model; at lr 1e-3: at 5e-3 this
    # run is chaotic (scripts/mamba2_chaos_witness.py nudges the weights by
    # as much as the card's rounding moves them and reads the losses), so
    # no fixed tolerance could tell a fault from rounding
    msmall = dataclasses.replace(get_config("mamba2-780m", smoke=True), vocab_size=32,
                                 ssm_chunk=64, compute_dtype="float32")
    reference_check(msmall, fc, 1e-3, 128, iter_fisher + ssd_names)

    kernels = []
    rows = (("compensate_packed", "iter_fisher.cu", "src/repro/kernels/packing.py:178", main,
             h2o_launches),
            ("stats_packed", "iter_fisher.cu", "src/repro/kernels/packing.py:220", main,
             h2o_launches),
            ("ssd_scan_fwd", "ssd_scan.cu", "src/repro/kernels/ssd_scan.py:77", ssd, m_launches),
            ("ssd_scan_bwd", "ssd_scan.cu", "src/repro/kernels/ssd_scan.py:77", ssd, m_launches))
    for name, source, replaces, res, launches in rows:
        r = res[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{source}",
            "replaces": replaces, "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
