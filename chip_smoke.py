#!/usr/bin/env python3
"""Run the PyTorch/CUDA port of Ferret end to end on one CUDA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit, then builds the CUDA kernels
   from ``src/repro_torch/csrc`` (nvcc, sm_90a).
2. Kernel phase: holds each kernel against its plain PyTorch version on
   the card, at the main path's shapes (the largest stage's packed length
   and Δθ depth) and on a small ragged tree, and times both with CUDA
   events.
3. Path phase: ``FerretTrainer.run_stream`` at the full width of
   h2o-danube-1.8b (4 of its 24 layers), batch 2, seq 1024, Iter-Fisher
   with λ tuning, 32 rounds in 2 segments. The kernels' launch counts are
   zeroed just before and read just after; both kernels must have run.
4. Reference check: the same trainer at smoke size on the card and on the
   CPU (plain versions) from the same weights must agree.
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

# H100 SXM data-sheet peaks (dense, 700 W): device memory and fp32 outside
# the tensor cores, the type both kernels compute in.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


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


def bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.core.compensation import CompensationConfig
    from repro_torch.core.ferret import FerretConfig, FerretTrainer
    from repro_torch.core.schedule import ring_geometry
    from repro_torch.kernels import _build, packing
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_config
    from repro_torch.ocl.streams import StreamConfig, make_stream

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

    # ---- the main path's configuration -------------------------------------
    cfg = dataclasses.replace(get_config("h2o-danube-1.8b"), num_layers=4)
    batch, seq, rounds, seg = 2, 1024, 32, 16
    fc = FerretConfig(
        budget_bytes=float("inf"), lr=1e-4, max_workers=3, max_stages=4,
        compensation=CompensationConfig(method="iter_fisher", eta_lambda=1e-4),
    )
    trainer = FerretTrainer(cfg, fc, batch=batch, seq=seq)
    plan = trainer.plan
    P = plan.partition.num_stages
    K = ring_geometry(plan.config, P).delta_ring
    shapes = T.param_shapes(cfg)
    meta = {k: (torch.empty(v, device="meta") if isinstance(v, tuple)
                else {n: torch.empty(s, device="meta") for n, s in v.items()})
            for k, v in shapes.items()}
    totals = [packing.pack_spec(sp).total
              for sp in T.split_stage_params(cfg, meta, plan.partition.bounds)]
    print(f"[config] {cfg.name}: d_model={cfg.d_model} heads={cfg.num_heads}/{cfg.num_kv_heads} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} window={cfg.window} "
          f"params={cfg.param_dtype} compute={cfg.compute_dtype}", flush=True)
    print(f"[config] reduced: num_layers 24 -> {cfg.num_layers}; batch={batch} seq={seq} "
          f"rounds={rounds} in segments of {seg}", flush=True)
    print(f"[plan] P={P} bounds={list(plan.partition.bounds)} "
          f"tau={[P - 1 - j for j in range(P)]} delta_ring={K} "
          f"workers={len(plan.config.active_workers())} packed_totals={totals}", flush=True)

    # ---- kernel phase --------------------------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    main = kernel_checks(max(totals), K, gen, "main-path")
    ragged = {"w": torch.empty(33, 17), "b": torch.empty(5), "s": torch.empty(()),
              "d": torch.empty(4097)}
    kernel_checks(packing.pack_spec(ragged).total, 3, gen, "ragged")
    torch.cuda.empty_cache()

    # ---- path phase ------------------------------------------------------------
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    # token ids from the first 512 of the 32000 (the Markov source's tables
    # are vocab² floats)
    stream = make_stream(StreamConfig(kind="drift", modality="tokens", length=rounds,
                                      batch=batch, vocab=512, seq=seq, seed=0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    packing.reset_launches()
    t0 = time.perf_counter()
    res = trainer.run_stream(params, stream, segment_rounds=seg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(packing.LAUNCHES)
    check(res.rounds == rounds, f"ran {res.rounds} rounds, expected {rounds}")
    check(bool(np.isfinite(res.losses).all()), f"non-finite losses: {res.losses}")
    check(bool(np.isfinite(res.lam_curve).all()), "non-finite λ")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    print(f"[path] online_acc={res.online_acc:.4f} loss first={res.losses[0]:.4f} "
          f"last={res.losses[-1]:.4f} lam_last={res.lam_curve[-1]:.7f} "
          f"ms_per_round={wall / rounds * 1e3:.1f} (first use included) "
          f"max_memory_allocated={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"launches={launches}", flush=True)
    del params, trainer, res
    torch.cuda.empty_cache()

    # ---- reference check: card vs CPU at smoke size --------------------------------
    small = dataclasses.replace(get_config("h2o-danube-1.8b", smoke=True), num_layers=4,
                                vocab_size=32, compute_dtype="float32")
    sfc = dataclasses.replace(fc, lr=5e-3)
    sparams = T.init_params(small, torch.Generator().manual_seed(1))
    sstream = make_stream(StreamConfig(kind="iid", modality="tokens", length=48, batch=2,
                                       vocab=32, seq=16, seed=0))
    on_card = FerretTrainer(small, sfc, 2, 16).run_stream(sparams, sstream, segment_rounds=16)
    on_cpu = FerretTrainer(small, sfc, 2, 16, device="cpu").run_stream(
        sparams, sstream, segment_rounds=16)
    # fp32 on both; sums run in other orders on the card, and 48 rounds of
    # Adam carry that drift (the CPU port and the JAX package differ by ~3e-5)
    loss_err = float(np.abs(on_card.losses - on_cpu.losses).max())
    lam_err = float(np.abs(on_card.lam_curve - on_cpu.lam_curve).max())
    check(loss_err <= 1e-3, f"card and CPU losses differ by {loss_err}")
    check(lam_err <= 1e-5, f"card and CPU λ differ by {lam_err}")
    check(abs(on_card.online_acc - on_cpu.online_acc) <= 0.02, "online accuracy differs")
    print(f"[reference] smoke trainer card vs CPU: max |Δloss|={loss_err:.3g} "
          f"max |Δλ|={lam_err:.3g} online_acc {on_card.online_acc:.4f} vs "
          f"{on_cpu.online_acc:.4f}", flush=True)

    kernels = []
    for name, replaces in (("compensate_packed", "src/repro/kernels/packing.py:178"),
                           ("stats_packed", "src/repro/kernels/packing.py:220")):
        r = main[name]
        kernels.append({
            "name": name, "route": "cuda", "source": "src/repro_torch/csrc/iter_fisher.cu",
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
