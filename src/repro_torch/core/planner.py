"""Model partitioning and pipeline planning (paper §5.2, Alg. 2 + Alg. 3).

Bi-level optimization:
  outer (Alg. 3)  — enumerate stage-time caps t^c from the profile, greedily
                    group consecutive layers into stages, and keep the
                    partition whose inner solution maximizes R_F^T;
  inner (Alg. 2)  — given a partition, progressively deploy T1–T4 by the
                    best ΔM/ΔR ratio until M_F ≤ M.

Both run once, on the host, before the pipeline starts (the paper reports
O(N·P²) for Alg. 2 and O(L̂³) for Alg. 3).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

from repro_torch.core import cost_model as cm
from repro_torch.core.profiler import ModelProfile


@dataclasses.dataclass
class Plan:
    partition: cm.Partition
    config: cm.PipelineConfig
    rate: float
    memory: float
    stats: cm.StageStats
    t_c: float  # chosen stage-time cap
    feasible: bool
    # provenance of the profile this plan was derived from
    # ("analytic" | "measured" | "online")
    profile_provenance: str = "analytic"


# ---------------------------------------------------------------------------
# Alg. 2 — iterative configuration search
# ---------------------------------------------------------------------------


def _initial_config(
    stats: cm.StageStats, t_d: float, c_r: int, max_workers: Optional[int] = None
) -> cm.PipelineConfig:
    """N = ⌈(t^f + t^b + c^r t^f)/t^d⌉ interleaved workers, c_n^d = n."""
    P = len(stats.w)
    step = stats.t_f + stats.t_b + c_r * stats.t_f
    N = max(1, math.ceil(step / t_d))
    if max_workers is not None:
        N = min(N, max_workers)
    workers = [
        cm.WorkerConfig(delay=n, recompute=c_r, stages=[cm.StageKnobs() for _ in range(P)])
        for n in range(N)
    ]
    return cm.PipelineConfig(workers=workers)


def itersearch(
    stats: cm.StageStats,
    t_d: float,
    c_r: int,
    budget: float,
    c: float = 1.0,
    V_D: float = 1.0,
    base_bytes: int = 0,
    max_workers: Optional[int] = None,
) -> Tuple[cm.PipelineConfig, float, float, bool]:
    """Alg. 2 ``itersearch``: greedy T2/T3/T4 deployment until M_F ≤ M.

    Returns (config, R_F, M_F, feasible).
    """
    config = _initial_config(stats, t_d, c_r, max_workers)
    P = len(stats.w)
    mem = cm.memory_footprint(stats, config, base_bytes)

    while mem > budget:
        best = None  # (ratio, n, trial_worker, dR, dM)
        for n, worker in enumerate(config.workers):
            if worker.removed:
                continue
            candidates = []
            for j in range(P):
                r2 = cm.delta_s2(stats, worker, j, c, V_D)
                if r2 is not None:
                    candidates.append(r2)
                r3 = cm.delta_s3(stats, worker, j, c, V_D)
                if r3 is not None:
                    candidates.append(r3)
            r4 = cm.delta_s4(stats, worker, c, V_D)
            if r4 is not None:
                candidates.append(r4)
            for dR, dM, trial in candidates:
                if dM <= 0:
                    continue  # no memory saved — useless move
                ratio = dM / max(dR, 1e-30)
                if best is None or ratio > best[0]:
                    best = (ratio, n, trial, dR, dM)
        if best is None:
            # Nothing else to deploy: infeasible under this budget.
            return config, cm.adaptation_rate(stats, config, c, V_D), mem, False
        _, n, trial, _, _ = best
        config.workers[n] = trial
        mem = cm.memory_footprint(stats, config, base_bytes)

    return config, cm.adaptation_rate(stats, config, c, V_D), mem, True


def search(
    stats: cm.StageStats,
    t_d: float,
    budget: float,
    c: float = 1.0,
    V_D: float = 1.0,
    base_bytes: int = 0,
    max_workers: Optional[int] = None,
) -> Tuple[cm.PipelineConfig, float, float, bool]:
    """Alg. 2 ``search``: S1 evaluated separately (c^r ∈ {0, 1}), keep best R."""
    results = []
    for c_r in (0, 1):
        cfg, rate, mem, ok = itersearch(
            stats, t_d, c_r, budget, c, V_D, base_bytes, max_workers
        )
        results.append((ok, rate, -mem, cfg, mem))
    # Prefer feasible; among those, higher rate; among equal, lower memory.
    results.sort(key=lambda r: (r[0], r[1], r[2]), reverse=True)
    ok, rate, _, cfg, mem = results[0]
    return cfg, rate, mem, ok


# ---------------------------------------------------------------------------
# Alg. 3 — brute-force planning
# ---------------------------------------------------------------------------


def _candidate_caps(profile: ModelProfile) -> List[float]:
    """All contiguous-range sums of (t^f_i + t^b_i) — candidate t^c values."""
    times = [ly.t_fwd + ly.t_bwd for ly in profile.layers]
    caps = set()
    for i in range(len(times)):
        acc = 0.0
        for j in range(i, len(times)):
            acc += times[j]
            caps.add(round(acc, 15))
    return sorted(caps)


def _partition_for_cap(profile: ModelProfile, t_c: float) -> Optional[cm.Partition]:
    """Greedy consecutive grouping (Alg. 3 lines 11–16)."""
    bounds = [0]
    acc = 0.0
    for i, ly in enumerate(profile.layers):
        t = ly.t_fwd + ly.t_bwd
        if t > t_c + 1e-18:
            return None  # single layer exceeds the cap
        if acc + t > t_c + 1e-18:
            bounds.append(i)
            acc = t
        else:
            acc += t
    bounds.append(len(profile.layers))
    if bounds[-2] == bounds[-1]:
        bounds.pop()
    return cm.Partition(tuple(bounds))


def plan(
    profile: ModelProfile,
    t_d: float,
    budget: float,
    c: float = 1.0,
    V_D: float = 1.0,
    include_base: bool = True,
    max_workers: Optional[int] = None,
    max_stages: Optional[int] = None,
) -> Plan:
    """Alg. 3 ``plan``: enumerate t^c, inner-search each partition, keep best."""
    best: Optional[Plan] = None
    base = profile.embed_bytes if include_base else 0
    seen_partitions = set()
    for t_c in _candidate_caps(profile):
        part = _partition_for_cap(profile, t_c)
        if part is None or tuple(part.bounds) in seen_partitions:
            continue
        seen_partitions.add(tuple(part.bounds))
        if max_stages is not None and part.num_stages > max_stages:
            continue
        stats = cm.stage_stats(profile, part)
        config, rate, mem, ok = search(
            stats, t_d, budget, c, V_D, base_bytes=base, max_workers=max_workers
        )
        cand = Plan(
            part, config, rate, mem, stats, t_c, ok,
            profile_provenance=getattr(profile, "provenance", "analytic"),
        )
        if best is None:
            best = cand
            continue
        # feasible beats infeasible; then higher rate; then lower memory
        key = (cand.feasible, cand.rate, -cand.memory)
        best_key = (best.feasible, best.rate, -best.memory)
        if key > best_key:
            best = cand
    assert best is not None, "no candidate partitions (empty profile?)"
    return best


def default_data_interval(profile: ModelProfile) -> float:
    """Paper §12: t^d = max_i t̂_i^f (one layer-forward per arrival)."""
    return max(ly.t_fwd for ly in profile.layers)
