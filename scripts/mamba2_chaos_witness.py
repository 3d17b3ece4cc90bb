#!/usr/bin/env python3
"""How far rounding alone moves the mamba2 smoke trainer's losses.

    python3 scripts/mamba2_chaos_witness.py

At lr 5e-3 and 1e-3 and seq 16 and 128, the mamba2-780m smoke trainer
(vocab 32, chunk 64, fp32, Iter-Fisher with eta_lambda 1e-4 as in
``chip_smoke.py``; 48 rounds in segments of 16) runs from the same weights:

1. on the card and on the CPU: ``card_vs_cpu`` is the largest difference of
   their losses, the reading ``chip_smoke.py``'s reference check holds to
   1e-3;
2. on both for 1, 2, ... rounds until their weights first differ:
   ``first_difference`` is the relative L2 difference of all weights then,
   what the card's other summation order does to the weights at once;
3. on the card again, three times, from weights each multiplied by
   ``1 ± nudge`` (random signs; ``nudge`` is ``first_difference``, or one
   fp32 rounding, 2^-23, if that is smaller): ``card_vs_nudged_card`` is the largest
   difference of those losses from the unnudged card run's, and
   ``cpu_vs_nudged_cpu`` the same on the CPU.

If ``card_vs_nudged_card`` reaches ``card_vs_cpu``, the card-vs-CPU gap is
what rounding of that size does to this run, not a fault of the card's
kernels. Prints one line per setting and a JSON line at the end. Needs a
CUDA card.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ROUNDS, SEGMENT, NUDGES = 48, 16, 3
LRS, SEQS = (5e-3, 1e-3), (16, 128)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("mamba2_chaos_witness: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.compensation import CompensationConfig
    from repro_torch.core.ferret import FerretConfig, FerretTrainer
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_config
    from repro_torch.ocl.streams import StreamConfig, make_stream
    from repro_torch.tree import tree_leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0], flush=True)

    cfg = dataclasses.replace(get_config("mamba2-780m", smoke=True), vocab_size=32,
                              ssm_chunk=64, compute_dtype="float32")
    params = T.init_params(cfg, torch.Generator().manual_seed(1))

    def run(lr, seq, device, weights, rounds=ROUNDS):
        fc = FerretConfig(budget_bytes=float("inf"), lr=lr, max_workers=3, max_stages=4,
                          compensation=CompensationConfig(method="iter_fisher",
                                                          eta_lambda=1e-4))
        stream = make_stream(StreamConfig(kind="iid", modality="tokens", length=rounds,
                                          batch=2, vocab=32, seq=seq, seed=0))
        tr = FerretTrainer(cfg, fc, 2, seq, device=device)
        res = tr.run_stream(weights, stream, segment_rounds=SEGMENT)
        return res.losses, tree_map(lambda t: t.cpu(), tr.final_params)

    def rel_diff(a, b):  # relative L2 difference over all weights at once
        pairs = list(zip(tree_leaves(a), tree_leaves(b)))
        num = sum(float(torch.sum((x.double() - y.double()) ** 2)) for x, y in pairs)
        return (num / sum(float(torch.sum(y.double() ** 2)) for _, y in pairs)) ** 0.5

    def nudged(weights, size, seed):
        g = torch.Generator().manual_seed(100 + seed)
        return tree_map(lambda t: t * (1.0 + size * (2.0 * torch.randint(
            0, 2, t.shape, generator=g, dtype=t.dtype) - 1.0)), weights)

    out = []
    for lr in LRS:
        for seq in SEQS:
            card, _ = run(lr, seq, "cuda", params)
            cpu, _ = run(lr, seq, "cpu", params)
            size, first = 0.0, 0
            for k in range(1, 9):
                size = rel_diff(run(lr, seq, "cuda", params, k)[1],
                                run(lr, seq, "cpu", params, k)[1])
                if size > 0.0:
                    first = k
                    break
            # a weight moves by at least one fp32 rounding, or not at all
            check = max(size, 2.0 ** -23)
            on_card = max(float(np.abs(run(lr, seq, "cuda", nudged(params, check, s))[0]
                                       - card).max()) for s in range(NUDGES))
            on_cpu = max(float(np.abs(run(lr, seq, "cpu", nudged(params, check, s))[0]
                                      - cpu).max()) for s in range(NUDGES))
            row = {"lr": lr, "seq": seq, "card_vs_cpu": float(np.abs(card - cpu).max()),
                   "first_round_differing": first, "first_difference": size, "nudge": check,
                   "card_vs_nudged_card": on_card, "cpu_vs_nudged_cpu": on_cpu}
            print(f"[witness] lr={lr} seq={seq}: card vs CPU max |dloss|={row['card_vs_cpu']:.4g}; "
                  f"weights first differ after round {first} by {size:.3g} (relative L2); "
                  f"a nudge of {check:.3g} moves the card's losses by {on_card:.4g}, the CPU's by "
                  f"{on_cpu:.4g}", flush=True)
            out.append(row)
    print(json.dumps({"witness": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
