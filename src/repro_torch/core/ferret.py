"""Ferret trainer: plan → schedule → pipeline-execute an OCL stream.

Counterpart of ``FerretTrainer.run_stream`` in ``repro.core.ferret``:

    profile = analytic per-layer profile (or the caller's)
    plan    = Alg. 3 ∘ Alg. 2  (partition L*, config C* s.t. M_F ≤ M)
    engine  = fine-grained async pipeline with Iter-Fisher compensation

``run_stream`` pulls the stream segment by segment. Each segment runs a
slice of one causal schedule build, padded to the segment length with
inert rounds, with the engine's gradient-accumulation and Δθ rings carried
across segments, so a run in segments equals one run over the whole
stream. The trainer waits for the card once per segment, when it reads the
segment's per-round results.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Union

import numpy as np
import torch

from repro_torch.api.streams import SegmentFeeder, StreamLike, as_stream_source
from repro_torch.core import compensation as comp_lib
from repro_torch.core import planner as planner_lib
from repro_torch.core import schedule as sched_lib
from repro_torch.core.pipeline import FerretEngine, staged_from_transformer
from repro_torch.core.profiler import ModelProfile, analytic_profile
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.ocl.registry import OCLAlgorithm, OCLConfig, get_algorithm
from repro_torch.optim.optimizers import Optimizer, adamw
from repro_torch.tree import tree_map

Tree = Any

# Rounds pulled from the stream per segment (and the length every segment's
# schedule is padded to). Override per run with run_stream(segment_rounds=...).
DEFAULT_PIPELINE_SEGMENT_ROUNDS = 32


@dataclasses.dataclass(frozen=True)
class FerretConfig:
    budget_bytes: float = math.inf  # M (Ferret_M+ := inf)
    decay_c: float = 1.0  # data-value decay rate c (Def. 4.1)
    data_value: float = 1.0  # V_D
    t_d: Optional[float] = None  # arrival interval; default max_i t̂_i^f (§12)
    lr: float = 1e-3
    max_workers: Optional[int] = 8
    max_stages: Optional[int] = None
    compensation: comp_lib.CompensationConfig = dataclasses.field(
        default_factory=comp_lib.CompensationConfig
    )
    ocl: OCLConfig = dataclasses.field(default_factory=OCLConfig)


@dataclasses.dataclass
class StreamResult:
    online_acc: float
    online_acc_curve: np.ndarray
    losses: np.ndarray
    admitted_frac: float
    memory_bytes: float
    planned_rate: float
    empirical_rate: float
    lam_curve: np.ndarray
    plan: planner_lib.Plan
    rounds: int = 0  # stream rounds consumed (exactly once)
    peak_buffered_rounds: int = 0  # max rounds held by the feeder
    stream_wait_s: float = 0.0  # time blocked on the source


def empirical_adaptation_rate(
    cfg: FerretConfig, plan: planner_lib.Plan, admitted: np.ndarray, R: int
) -> float:
    """Def. 4.1 empirically: admitted items complete after one full pipeline
    traversal; dropped items contribute 0 (r = ∞)."""
    active = plan.config.active_workers()
    cr = max(w.recompute for w in active) if active else 0
    traversal = plan.partition.num_stages * (
        plan.stats.t_f + plan.stats.t_b + cr * plan.stats.t_f
    )
    contrib = admitted * math.exp(-cfg.decay_c * traversal) * cfg.data_value
    return float(contrib.sum() / max(R, 1))


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another. Asking for the card where there is none raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU"
        )
    return device


class FerretTrainer:
    def __init__(
        self,
        model_cfg: ModelConfig,
        ferret_cfg: FerretConfig,
        batch: int,
        seq: int,
        optimizer: Optional[Optimizer] = None,
        profile: Optional[ModelProfile] = None,
        algorithm: Optional[Union[str, OCLAlgorithm]] = None,
        device: Union[None, str, torch.device] = None,
    ):
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.cfg = ferret_cfg
        self.batch = batch
        self.seq = seq
        self.algorithm = get_algorithm(algorithm if algorithm is not None else ferret_cfg.ocl)
        self.profile = profile or analytic_profile(model_cfg, batch, seq)
        self.t_d = ferret_cfg.t_d or planner_lib.default_data_interval(self.profile)
        self.plan = planner_lib.plan(
            self.profile,
            self.t_d,
            ferret_cfg.budget_bytes,
            c=ferret_cfg.decay_c,
            V_D=ferret_cfg.data_value,
            max_workers=ferret_cfg.max_workers,
            max_stages=ferret_cfg.max_stages,
        )
        self.boundaries = list(self.plan.partition.bounds)
        self.staged = self.algorithm.wrap_staged(
            staged_from_transformer(model_cfg, self.boundaries)
        )
        self.optimizer = optimizer or adamw(lr=ferret_cfg.lr)

    def run_stream(
        self,
        params: Tree,
        stream: StreamLike,
        *,
        segment_rounds: Optional[int] = None,
    ) -> StreamResult:
        """Execute a stream through the single-plan pipeline engine.

        ``params``: the model's tensor dict (moved to the trainer's device).
        ``stream``: a ``StreamSource`` or a dict of ``(R, b, ...)`` numpy
        arrays, consumed ``segment_rounds`` rounds at a time.
        """
        source = as_stream_source(stream)
        feeder = SegmentFeeder(source)
        seg = int(segment_rounds) if segment_rounds else DEFAULT_PIPELINE_SEGMENT_ROUNDS
        R: Optional[int] = source.remaining

        P = self.plan.partition.num_stages
        params = tree_map(lambda p: p.to(self.device), params)
        stages = T.split_stage_params(self.model_cfg, params, self.boundaries)
        engine: Optional[FerretEngine] = None
        full_sched: Optional[sched_lib.EngineSchedule] = None
        rings = deltas = opt_states = comp_states = None
        cursor = 0
        acc_all, loss_all, adm_all, lam_all = [], [], [], []
        while R is None or cursor < R:
            want = seg if R is None else min(seg, R - cursor)
            rows = feeder.take(want)
            if rows is None:
                break  # source exhausted
            rows = self.algorithm.prepare_stream(rows)
            seg_len = next(iter(rows.values())).shape[0]
            seg_end = cursor + seg_len
            if seg_len < want:
                R = seg_end  # source ended early: true stream end found
            # one causal build; segments slice it. Construction is causal,
            # so a longer rebuild (an unbounded stream grows geometrically)
            # is identical on its prefix.
            if full_sched is None or full_sched.num_rounds < seg_end:
                if R is not None:
                    build_len = max(R, seg_end)
                else:
                    built = 0 if full_sched is None else full_sched.num_rounds
                    build_len = max(seg_end, 2 * built, 2 * seg)
                full_sched = sched_lib.build_schedule(self.plan.config, P, build_len)
            # every segment has `seg` rounds; the padding rounds are inert
            engine_sched = sched_lib.pad_schedule(
                sched_lib.slice_schedule(full_sched, cursor, seg_end), seg
            )
            if engine is None:
                engine = FerretEngine(
                    self.staged, engine_sched, self.optimizer,
                    self.cfg.compensation, lr=self.cfg.lr,
                )
            else:
                engine.set_schedule(engine_sched)
            state = engine.init_state(stages, opt_states, comp_states, rings, deltas)
            seg_stream = {}
            for k, v in rows.items():
                if seg > seg_len:  # padding rounds repeat the last item (never run)
                    v = np.concatenate([v, np.repeat(v[-1:], seg - seg_len, axis=0)])
                seg_stream[k] = torch.as_tensor(v, device=self.device)
            final_state, ys = engine.run(state, seg_stream)
            stages = list(final_state.stage_params)
            rings = final_state.rings
            deltas = final_state.deltas
            opt_states = final_state.opt_states
            comp_states = final_state.comp_states
            # the one wait for the card in this segment
            ys = {k: v[:seg_len].cpu().numpy() for k, v in ys.items()}
            acc_all.append(ys["acc"].astype(np.float64))
            loss_all.append(ys["loss"])
            adm_all.append(ys["admitted"].astype(np.float64))
            lam_all.append(ys["lam"])
            cursor = seg_end

        self.final_params = T.merge_stage_params(self.model_cfg, stages)
        rounds = cursor
        acc = np.concatenate(acc_all) if acc_all else np.zeros(0)
        admitted = np.concatenate(adm_all) if adm_all else np.zeros(0)
        return StreamResult(
            online_acc=float(acc.mean()) if acc.size else 0.0,
            online_acc_curve=np.cumsum(acc) / np.arange(1, acc.size + 1),
            losses=np.concatenate(loss_all) if loss_all else np.zeros(0),
            admitted_frac=float(admitted.mean()) if admitted.size else 0.0,
            memory_bytes=self.plan.memory,
            planned_rate=self.plan.rate,
            empirical_rate=empirical_adaptation_rate(self.cfg, self.plan, admitted, rounds),
            lam_curve=np.concatenate(lam_all) if lam_all else np.zeros(0),
            plan=self.plan,
            rounds=rounds,
            peak_buffered_rounds=feeder.peak_buffered_rounds,
            stream_wait_s=feeder.take_wait_s,
        )
