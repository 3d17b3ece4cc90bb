"""Static schedule construction for the fine-grained pipeline engine.

The paper's asynchronous 1F1B pipeline has a *deterministic* schedule once
(L, C) are fixed: which arriving item is admitted (worker interleave /
removal, T4), which stages back-propagate it (omission, T3), when each
stage's (possibly accumulated, T2) gradient is applied, and how stale —
in stage-update counts — that gradient is at application time.

We precompute all of it here as numpy arrays. The engine
(`repro_torch.core.pipeline`) then reads them on the host round by round:
control flow never waits on the device, and the learning dynamics exactly
follow the paper's staleness model (∇L(D^t;θ^t) applied at θ^{t+τ},
Fig. 9, with τ_j = P-1-j for stage j, scaled by the worker interleave).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.cost_model import PipelineConfig

RING = "ring"  # sentinel docs


@dataclasses.dataclass(frozen=True)
class RingGeometry:
    """Per-stage ring depths a schedule's engine state is shaped for.

    Depends only on the pipeline config and stage count — *not* on the
    partition bounds or the number of rounds — which is what makes
    cross-partition ring remapping well-defined: two plans with equal
    ``(config, num_stages)`` share one geometry (and one schedule), so
    ring contents can move between their partitions slot-for-slot.
    """

    ring_size: int  # gradient-accumulation ring slots per stage
    delta_ring: int  # Δθ ring depth per stage (max staleness window)


def ring_geometry(
    config: PipelineConfig, num_stages: int, sync_period: Optional[int] = None
) -> RingGeometry:
    """Ring geometry for ``(config, num_stages)`` — the single source of
    truth ``build_schedule`` (and every remap/checkpoint/drain path)
    shapes ring arrays from."""
    if sync_period is not None:
        return RingGeometry(ring_size=1, delta_ring=1)
    P = num_stages
    tau_max = P - 1  # τ_j = P-1-j, maximized at stage 0
    max_accum = max(
        (s.accum for w in config.workers for s in w.stages), default=1
    )
    # gradient stays in its ring slot for ≤ N·(c_a-1) rounds of filling plus
    # N·τ_j rounds of delay; slots are recycled round-robin per stage.
    ring_size = int(2 + (tau_max if P > 1 else 0) + max_accum)
    delta_ring = int(max(tau_max + 1, 1))
    return RingGeometry(ring_size=ring_size, delta_ring=delta_ring)


@dataclasses.dataclass
class EngineSchedule:
    """All arrays indexed [round] or [round, stage]."""

    num_rounds: int
    num_stages: int
    ring_size: int  # gradient-accumulation ring slots per stage
    delta_ring: int  # Δθ ring depth per stage (max staleness)

    process: np.ndarray  # (R,) bool   — item admitted (worker not removed)
    backward: np.ndarray  # (R, P) bool — stage back-propagates this item (T3)
    push_slot: np.ndarray  # (R, P) int  — grad ring slot to accumulate into (-1: none)
    push_reset: np.ndarray  # (R, P) bool — first grad of its accumulation group
    pop_slot: np.ndarray  # (R, P) int  — grad ring slot to apply (-1: none)
    pop_scale: np.ndarray  # (R, P) f32  — 1/c^a normalization at apply time
    delta_mask: np.ndarray  # (R, P, K) f32 — which stacked Δθ entries are "live"
    delta_push_slot: np.ndarray  # (R, P) int — Δθ ring slot written on apply (-1: none)
    tau: np.ndarray  # (R, P) int — staleness (stage updates) at apply
    # (R,) bool — False only for bucket-padding rounds (pad_schedule): the
    # engine skips the forward/backward entirely, not just the masked
    # apply. None means all-true (every real schedule).
    compute: Optional[np.ndarray] = None

    def stats(self) -> dict:
        return {
            "admitted": int(self.process.sum()),
            "updates": int((self.pop_slot >= 0).sum()),
            "mean_tau": float(self.tau[self.pop_slot >= 0].mean())
            if (self.pop_slot >= 0).any()
            else 0.0,
        }


def build_schedule(
    config: PipelineConfig,
    num_stages: int,
    num_rounds: int,
    sync_period: Optional[int] = None,
    phase: int = 0,
    warmup: int = 0,
) -> EngineSchedule:
    """Builds the engine schedule for a pipeline configuration.

    sync_period: if set, emulate a *synchronous* pipeline instead — every
    stage accumulates `sync_period` items and applies a fresh (τ=0) update
    at the group boundary (DAPPLE/GPipe-style flushes). Ferret's async
    schedule is `sync_period=None`.

    phase: global round index of this schedule's first round. A segmented
    run passes the stream cursor so the worker
    interleave — and hence the T4 admission pattern — continues seamlessly
    across segment boundaries instead of restarting at worker 0.

    warmup: number of rounds to *simulate* before the ``num_rounds``
    emitted rounds (``phase`` then addresses the first simulated round).
    The result equals rows ``[warmup:warmup+num_rounds)`` of one big
    build, so in-flight accumulation groups, ring slots, staleness
    counters and pending pops continue exactly across a segment boundary —
    provided the engine's gradient/Δθ rings are carried over too.
    O(warmup) extra host work.
    """
    if warmup:
        full = build_schedule(
            config, num_stages, warmup + num_rounds,
            sync_period=sync_period, phase=phase,
        )
        return slice_schedule(full, warmup)
    P = num_stages
    R = num_rounds
    workers = config.workers
    N = max(len(workers), 1)

    taus = np.array([P - 1 - j for j in range(P)], dtype=np.int64)

    process = np.zeros(R, dtype=bool)
    backward = np.zeros((R, P), dtype=bool)
    push_slot = -np.ones((R, P), dtype=np.int32)
    push_reset = np.zeros((R, P), dtype=bool)
    pop_slot = -np.ones((R, P), dtype=np.int32)
    pop_scale = np.zeros((R, P), dtype=np.float32)
    tau_arr = np.zeros((R, P), dtype=np.int32)
    delta_push_slot = -np.ones((R, P), dtype=np.int32)

    if sync_period is not None:
        K = max(int(sync_period), 1)
        geom = ring_geometry(config, P, sync_period)
        ring_size, delta_ring = geom.ring_size, geom.delta_ring
        for m in range(R):
            process[m] = True
            backward[m, :] = True
            push_slot[m, :] = 0
            push_reset[m, :] = (m % K) == 0
            if (m % K) == K - 1:
                pop_slot[m, :] = 0
                pop_scale[m, :] = 1.0 / K
                delta_push_slot[m, :] = 0
        delta_mask = np.zeros((R, P, delta_ring), dtype=np.float32)
        return EngineSchedule(
            R, P, ring_size, delta_ring, process, backward, push_slot, push_reset,
            pop_slot, pop_scale, delta_mask, delta_push_slot, tau_arr,
        )

    # ---- asynchronous fine-grained schedule (Ferret) ----
    geom = ring_geometry(config, P)
    ring_size, delta_ring = geom.ring_size, geom.delta_ring

    # Per-(worker, stage) running state during construction.
    seen = np.zeros((N, P), dtype=np.int64)  # worker-local item count
    grp_count = np.zeros((N, P), dtype=np.int64)  # grads accumulated in open group
    grp_slot = -np.ones((N, P), dtype=np.int64)  # open group's ring slot
    next_slot = np.zeros(P, dtype=np.int64)  # per-stage round-robin slot counter

    upd_count = np.zeros(P, dtype=np.int64)  # total updates applied per stage
    # pending pops: list per round of (stage, slot, scale, upd_count_at_enqueue)
    pending = [[] for _ in range(R)]

    for m in range(R):
        w = (m + phase) % N
        worker = workers[w]
        if worker.removed:
            continue
        process[m] = True
        for j in range(P):
            knobs = worker.stages[j]
            k_local = seen[w, j]
            seen[w, j] += 1
            if k_local % (knobs.omit + 1) != 0:
                continue  # T3: omitted backward
            backward[m, j] = True
            if grp_count[w, j] == 0:
                grp_slot[w, j] = next_slot[j] % ring_size
                next_slot[j] += 1
                push_reset[m, j] = True
            push_slot[m, j] = grp_slot[w, j]
            grp_count[w, j] += 1
            if grp_count[w, j] >= knobs.accum:
                # group complete: schedule the apply after the pipeline delay
                pop_round = m + int(N * taus[j])
                if pop_round < R:
                    pending[pop_round].append(
                        (j, int(grp_slot[w, j]), 1.0 / knobs.accum, m)
                    )
                grp_count[w, j] = 0
                grp_slot[w, j] = -1

        # apply any pops scheduled for this round (computed below via second loop)

    # Second pass: walk rounds again to resolve pops in order and track
    # per-stage update counts for staleness + Δθ ring slots.
    upd_at_round = np.zeros((R + 1, P), dtype=np.int64)
    delta_mask = np.zeros((R, P, delta_ring), dtype=np.float32)
    upd_count[:] = 0
    # Record at push-completion time the stage's update count; staleness at
    # pop = upd_count_then − upd_count_at_push.
    for m in range(R):
        for (j, slot, scale, m_push) in pending[m]:
            if pop_slot[m, j] >= 0:
                # Two groups of the same stage landing on one round cannot
                # happen: group completions per worker are ≥ N·c_a apart and
                # delays are worker-uniform. Guard anyway.
                raise RuntimeError("schedule conflict: two pops in one round")
            pop_slot[m, j] = slot
            pop_scale[m, j] = scale
            tau = int(upd_count[j] - upd_at_round[m_push, j])
            tau = min(tau, delta_ring)
            tau_arr[m, j] = tau
            # stacked Δθ given to the compensator is ordered oldest→newest in
            # the last `delta_ring` updates; mask the most recent `tau`.
            if tau > 0:
                delta_mask[m, j, delta_ring - tau :] = 1.0
            delta_push_slot[m, j] = int(upd_count[j] % delta_ring)
            upd_count[j] += 1
        upd_at_round[m + 1] = upd_count
    return EngineSchedule(
        R, P, ring_size, delta_ring, process, backward, push_slot, push_reset,
        pop_slot, pop_scale, delta_mask, delta_push_slot, tau_arr,
    )


def slice_schedule(
    s: EngineSchedule, start: int, end: Optional[int] = None
) -> EngineSchedule:
    """Rows ``[start:end)`` of a schedule (ring geometry unchanged).

    Construction is causal, so slicing one big build is exactly the
    continuation semantics: pushes before ``start`` whose pops land inside
    the window fire here (the engine's carried rings hold their partial
    groups), and pops landing beyond ``end`` fire in a later slice.
    """
    end = s.num_rounds if end is None else end
    return EngineSchedule(
        num_rounds=end - start,
        num_stages=s.num_stages,
        ring_size=s.ring_size,
        delta_ring=s.delta_ring,
        process=s.process[start:end],
        backward=s.backward[start:end],
        push_slot=s.push_slot[start:end],
        push_reset=s.push_reset[start:end],
        pop_slot=s.pop_slot[start:end],
        pop_scale=s.pop_scale[start:end],
        delta_mask=s.delta_mask[start:end],
        delta_push_slot=s.delta_push_slot[start:end],
        tau=s.tau[start:end],
        compute=None if s.compute is None else s.compute[start:end],
    )


def pad_schedule(s: EngineSchedule, num_rounds: int) -> EngineSchedule:
    """Extend to ``num_rounds`` with inert rounds (nothing admitted, no
    push, no pop), which are the identity on engine state.

    Every segment of a run then has the same round count, which a later
    CUDA-graph capture of one segment needs: the first ``s.num_rounds``
    rows are untouched, the padded tail leaves the engine state unchanged,
    and per-round outputs for padded rounds are zeros that the caller
    slices off. Padded rounds carry ``compute=False``, so the engine skips
    their forward/backward entirely.
    """
    pad = num_rounds - s.num_rounds
    if pad <= 0:
        return s
    P, K = s.num_stages, s.delta_ring

    def cat(a, fill):
        ext = np.full((pad,) + a.shape[1:], fill, dtype=a.dtype)
        return np.concatenate([np.asarray(a), ext], axis=0)

    compute = s.compute if s.compute is not None else np.ones(s.num_rounds, bool)
    return EngineSchedule(
        num_rounds=num_rounds,
        num_stages=P,
        ring_size=s.ring_size,
        delta_ring=K,
        process=cat(s.process, False),
        backward=cat(s.backward, False),
        push_slot=cat(s.push_slot, -1),
        push_reset=cat(s.push_reset, False),
        pop_slot=cat(s.pop_slot, -1),
        pop_scale=cat(s.pop_scale, 0.0),
        delta_mask=cat(s.delta_mask, 0.0),
        delta_push_slot=cat(s.delta_push_slot, -1),
        tau=cat(s.tau, 0),
        compute=cat(compute, False),
    )
