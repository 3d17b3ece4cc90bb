"""Ferret's analytic cost model (host-side copy of ``repro.core.cost_model``).

Implements, exactly as stated in the paper:
- Eq. 3  — adaptation rate R_F^T of the fine-grained pipeline
- Eq. 4  — memory footprint M_F
- Eq. 20 — S2 (gradient accumulation) deltas
- Eq. 21 — S3 (back-propagation omission) deltas
- Eq. 22 — S4 (worker removal) deltas

All quantities are host-side Python floats/ints (the planner runs once,
before training starts).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

from repro_torch.core.profiler import ModelProfile

# ---------------------------------------------------------------------------
# Configuration structures (the paper's L and C)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StageKnobs:
    accum: int = 1  # c_{n,j}^a  >= 1
    omit: int = 0  # c_{n,j}^o  >= 0


@dataclasses.dataclass
class WorkerConfig:
    delay: int  # c_n^d  (>= 0; -1 means removed)
    recompute: int = 0  # c_n^r  (0/1)
    stages: List[StageKnobs] = dataclasses.field(default_factory=list)

    @property
    def removed(self) -> bool:
        return self.delay < 0


@dataclasses.dataclass
class PipelineConfig:
    workers: List[WorkerConfig]

    def active_workers(self) -> List[WorkerConfig]:
        return [w for w in self.workers if not w.removed]

    def clone(self) -> "PipelineConfig":
        return PipelineConfig(
            workers=[
                WorkerConfig(
                    delay=w.delay,
                    recompute=w.recompute,
                    stages=[StageKnobs(s.accum, s.omit) for s in w.stages],
                )
                for w in self.workers
            ]
        )


@dataclasses.dataclass(frozen=True)
class Partition:
    """Model partition scheme L: stage j covers layers [bounds[j], bounds[j+1])."""

    bounds: Sequence[int]  # P+1 increasing ints, bounds[0]=0, bounds[-1]=num_layers

    @property
    def num_stages(self) -> int:
        return len(self.bounds) - 1

    def stage_layers(self, j: int) -> range:
        return range(self.bounds[j], self.bounds[j + 1])


@dataclasses.dataclass(frozen=True)
class StageStats:
    """Aggregated per-stage quantities from the profile + partition."""

    w: List[int]  # |w_j| bytes
    a: List[int]  # |a_j| bytes (all activations of the stage's layers)
    a_recomputable: List[int]  # c_r-subtractable bytes: Σ_{l=L_j+1}^{L_{j+1}-1} |â_l|
    t_f: float  # max-stage forward time
    t_b: float  # max-stage backward time


def stage_stats(profile: ModelProfile, part: Partition) -> StageStats:
    w, a, a_rec = [], [], []
    tf_list, tb_list = [], []
    for j in range(part.num_stages):
        layers = [profile.layers[i] for i in part.stage_layers(j)]
        w.append(sum(ly.w_bytes for ly in layers))
        a.append(sum(ly.a_bytes + ly.a_internal_bytes for ly in layers))
        # Eq. 4: T1 drops Σ_{l=L_i+1}^{L_{i+1}-1} |â_l| — everything except the
        # first layer's activations (the stage input survives for recompute).
        a_rec.append(sum(ly.a_bytes + ly.a_internal_bytes for ly in layers[1:]))
        tf_list.append(sum(ly.t_fwd for ly in layers))
        tb_list.append(sum(ly.t_bwd for ly in layers))
    return StageStats(w=w, a=a, a_recomputable=a_rec, t_f=max(tf_list), t_b=max(tb_list))


# ---------------------------------------------------------------------------
# Eq. 3 — adaptation rate
# ---------------------------------------------------------------------------


def _lcm_tail(stages: List[StageKnobs], i: int) -> int:
    """LCM({c^o_{n,k} + 1 | k ∈ [i, P-1]})."""
    out = 1
    for k in range(i, len(stages)):
        out = math.lcm(out, stages[k].omit + 1)
    return out


def _A_term(
    i: int,
    j: int,
    P: int,
    t_f: float,
    t_b: float,
    c_r: int,
    lcm: int,
    c: float,
    V_D: float,
) -> float:
    """A_{i,j} of Eq. 3."""
    expo = -c * ((P + j) * t_f + (P - i + j) * t_b + c_r * (P - i + j) * t_f)
    denom = lcm * (t_f + t_b + c_r * t_f)
    return math.exp(expo) * V_D / denom


def worker_rate(
    stats: StageStats, worker: WorkerConfig, c: float = 1.0, V_D: float = 1.0
) -> float:
    """Inner double sum of Eq. 3 for one worker."""
    if worker.removed:
        return 0.0
    P = len(stats.w)
    w_total = float(sum(stats.w))
    total = 0.0
    for i in range(P):
        knobs = worker.stages[i]
        lcm = _lcm_tail(worker.stages, i)
        inner = sum(
            _A_term(i, j, P, stats.t_f, stats.t_b, worker.recompute, lcm, c, V_D)
            for j in range(knobs.accum)
        )
        total += (stats.w[i] / w_total) * inner / knobs.accum
    return total


def adaptation_rate(
    stats: StageStats, config: PipelineConfig, c: float = 1.0, V_D: float = 1.0
) -> float:
    """Eq. 3: R_F^T."""
    return sum(worker_rate(stats, w, c, V_D) for w in config.workers)


# ---------------------------------------------------------------------------
# Eq. 4 — memory footprint
# ---------------------------------------------------------------------------


def _stage_copies(P: int, i: int, knobs: StageKnobs) -> int:
    """(1 + ⌈(P-i-1)/c^a⌉ - c^o) — number of live (weights+activations) copies."""
    return 1 + math.ceil((P - i - 1) / knobs.accum) - knobs.omit


def worker_memory(stats: StageStats, worker: WorkerConfig) -> float:
    if worker.removed:
        return 0.0
    P = len(stats.w)
    total = 0.0
    for i in range(P):
        copies = _stage_copies(P, i, worker.stages[i])
        footprint = stats.w[i] + stats.a[i] - worker.recompute * stats.a_recomputable[i]
        total += max(copies, 0) * footprint
    return total


def memory_footprint(
    stats: StageStats, config: PipelineConfig, base_bytes: int = 0
) -> float:
    """Eq. 4: M_F (+ optional per-worker base bytes for embed/head)."""
    active = config.active_workers()
    return sum(worker_memory(stats, w) for w in active) + base_bytes * len(active)


# ---------------------------------------------------------------------------
# Eq. 20–22 — closed-form deltas for S2–S4
# (ΔR and ΔM are the *reductions*, i.e. old − new; positive = decrease.)
# ---------------------------------------------------------------------------


def s2_accum_increment(P: int, j: int, c_a: int) -> Optional[int]:
    """Δc^a of Eq. 20 — chosen so the ceiling actually drops; None = +∞."""
    k = math.ceil((P - j - 1) / c_a)
    if k <= 1:
        return None  # Δc^a = +∞: T2 exhausted for this stage (S3 takes over)
    return math.ceil((P - j - 1) / (k - 1)) - c_a


def delta_s2(
    stats: StageStats, worker: WorkerConfig, j: int, c: float = 1.0, V_D: float = 1.0
):
    """Eq. 20: increase c^a_{n,j} by Δc^a (requires c^o_{n,j} = 0)."""
    if worker.removed or worker.stages[j].omit != 0:
        return None
    P = len(stats.w)
    inc = s2_accum_increment(P, j, worker.stages[j].accum)
    if inc is None or inc <= 0:
        return None
    trial = WorkerConfig(worker.delay, worker.recompute,
                         [StageKnobs(s.accum, s.omit) for s in worker.stages])
    trial.stages[j].accum += inc
    dR = worker_rate(stats, worker, c, V_D) - worker_rate(stats, trial, c, V_D)
    dM = worker_memory(stats, worker) - worker_memory(stats, trial)
    return dR, dM, trial


def delta_s3(
    stats: StageStats, worker: WorkerConfig, j: int, c: float = 1.0, V_D: float = 1.0
):
    """Eq. 21: c^a_{n,j} → 1, c^o_{n,j} → P-1-j (requires T2 exhausted)."""
    if worker.removed:
        return None
    P = len(stats.w)
    if j >= P - 1:
        return None  # no staleness at the last stage; omission is a no-op
    if worker.stages[j].omit != 0:
        return None
    if s2_accum_increment(P, j, worker.stages[j].accum) is not None:
        return None  # S3 only once Δc^a = +∞
    trial = WorkerConfig(worker.delay, worker.recompute,
                         [StageKnobs(s.accum, s.omit) for s in worker.stages])
    trial.stages[j].accum = 1
    trial.stages[j].omit = P - 1 - j
    dR = worker_rate(stats, worker, c, V_D) - worker_rate(stats, trial, c, V_D)
    dM = worker_memory(stats, worker) - worker_memory(stats, trial)
    return dR, dM, trial


def delta_s4(stats: StageStats, worker: WorkerConfig, c: float = 1.0, V_D: float = 1.0):
    """Eq. 22: remove the worker (requires c^o ≠ 0 on all non-final stages)."""
    if worker.removed:
        return None
    P = len(stats.w)
    if any(worker.stages[j].omit == 0 for j in range(P - 1)):
        return None
    trial = WorkerConfig(-1, worker.recompute,
                         [StageKnobs(s.accum, s.omit) for s in worker.stages])
    dR = worker_rate(stats, worker, c, V_D)
    dM = worker_memory(stats, worker)
    return dR, dM, trial
