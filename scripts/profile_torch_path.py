#!/usr/bin/env python3
"""Where a round of the PyTorch/CUDA port's main path spends its time.

    python3 scripts/profile_torch_path.py [--arch h2o-danube-1.8b|mamba2-780m]

Runs ``FerretTrainer.run_stream`` at one of the path configurations of
``chip_smoke.py`` (full width, batch 2, seq 1024, Iter-Fisher with λ
tuning; h2o-danube-1.8b with 4 of 24 layers, the default, or mamba2-780m
with 16 of 48) three times on the same trainer: once to warm up, once
timed on the host clock, once under ``torch.profiler``. Prints
the card's name and power limit, the steady-state ms per round, and one
JSON line with the device time per kernel group and the device's busy and
idle share of the profiled run, after the profiler's table of the 40
costliest operations. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# depth each architecture is cut to (as in chip_smoke.py)
LAYERS = {"h2o-danube-1.8b": 4, "mamba2-780m": 16}

GROUPS = (  # first match wins
    ("iter_fisher_kernels", ("compensate_kernel", "stats_kernel", "sum_partials_kernel")),
    ("ssd_kernels", ("chunk_outer_kernel", "state_scan_kernel", "fwd_out_kernel",
                     "state_rscan_kernel", "bwd_row_kernel", "bwd_col_kernel",
                     "bwd_dt_kernel", "sum_mid_kernel")),
    ("matmul", ("gemm", "nvjet", "sm90_", "cutlass", "xmma", "cublas", "splitk")),
    ("softmax", ("softmax",)),
    ("reduce", ("reduce",)),
    ("copy_fill", ("memcpy", "memset", "copy", "fill", "cat", "index")),
)


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other_elementwise"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--arch", choices=sorted(LAYERS), default="h2o-danube-1.8b")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_path: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.compensation import CompensationConfig
    from repro_torch.core.ferret import FerretConfig, FerretTrainer
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_config
    from repro_torch.ocl.streams import StreamConfig, make_stream

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    cfg = dataclasses.replace(get_config(args.arch), num_layers=LAYERS[args.arch])
    print(f"{cfg.name}: {cfg.num_layers} layers at full width, batch 2, seq 1024")
    rounds = 32
    fc = FerretConfig(budget_bytes=float("inf"), lr=1e-4, max_workers=3, max_stages=4,
                      compensation=CompensationConfig(method="iter_fisher", eta_lambda=1e-4))
    trainer = FerretTrainer(cfg, fc, batch=2, seq=1024)
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    stream = make_stream(StreamConfig(kind="drift", modality="tokens", length=rounds, batch=2,
                                      vocab=512, seq=1024, seed=0))

    trainer.run_stream(params, stream, segment_rounds=rounds)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.run_stream(params, stream, segment_rounds=rounds)
    torch.cuda.synchronize()
    ms_round = (time.perf_counter() - t0) / rounds * 1e3

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.run_stream(params, stream, segment_rounds=rounds)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    by_group: dict = {}
    busy_us = 0.0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dur = ev.time_range.elapsed_us()
        busy_us += dur
        by_group[group_of(ev.name)] = by_group.get(group_of(ev.name), 0.0) + dur
    if busy_us == 0:
        print("profile_torch_path: the profiler recorded no device time", file=sys.stderr)
        return 1
    print(prof.key_averages().table(sort_by="device_time_total", row_limit=40))
    print(f"ms_per_round_steady={ms_round:.2f} (host clock, no profiler, {rounds} rounds "
          "after a warm-up run)")
    print(json.dumps({
        "arch": cfg.name,
        "num_layers": cfg.num_layers,
        "rounds": rounds,
        "ms_per_round_steady": ms_round,
        "profiled_wall_ms": wall_ms,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": max(0.0, 1.0 - busy_us / 1e3 / wall_ms),
        # the same device work against the timed run without the profiler
        "device_idle_share_unprofiled": max(0.0, 1.0 - busy_us / 1e3 / (ms_round * rounds)),
        "device_ms_by_group": {k: v / 1e3 for k, v in sorted(by_group.items())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
