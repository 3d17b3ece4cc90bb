"""The port's planner, schedule and pipeline engine vs the JAX package.

Planning and schedules are host numpy on both sides and must be equal.
The engine runs one ``EngineSchedule`` on the same bridged weights and
stream in both frameworks; per-round loss and accuracy are held to 1e-4
and λ to 1e-5 (fp32 training over a few dozen rounds: matrix products sum
in other orders in XLA and PyTorch, and Adam carries that drift).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke_cfg
from repro.core import cost_model as jcm
from repro.core import planner as jplanner
from repro.core import schedule as jsched
from repro.core.compensation import CompensationConfig as JCompCfg
from repro.core.pipeline import FerretEngine as JEngine
from repro.core.pipeline import staged_from_transformer as jstaged
from repro.core.profiler import analytic_profile as janalytic
from repro.models import transformer as JT
from repro.ocl.streams import StreamConfig, make_stream
from repro.optim.optimizers import adamw as jadamw
from repro_torch.bridge import params_from_numpy
from repro_torch.core import cost_model as cm
from repro_torch.core import planner, schedule
from repro_torch.core.compensation import CompensationConfig
from repro_torch.core.pipeline import FerretEngine, staged_from_transformer
from repro_torch.core.profiler import LayerProfile, ModelProfile
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_config
from repro_torch.optim.optimizers import adamw


def _port_profile(jprof):
    return ModelProfile([LayerProfile(**dataclasses.asdict(ly)) for ly in jprof.layers],
                        jprof.embed_bytes, jprof.batch, jprof.seq, jprof.provenance)


def _port_config(jconfig):
    return cm.PipelineConfig(workers=[
        cm.WorkerConfig(w.delay, w.recompute, [cm.StageKnobs(s.accum, s.omit) for s in w.stages])
        for w in jconfig.workers
    ])


def _tiny_profile():
    jcfg = smoke_cfg("h2o-danube-1.8b", num_layers=4, vocab_size=32)
    return jcfg, janalytic(jcfg, 2, 16)


def _hetero_profile():
    """Layers of unequal cost, so partitions other than one layer per stage win."""
    _, jprof = _tiny_profile()
    scales = [1.0, 3.0, 0.5, 2.0]
    layers = [dataclasses.replace(ly, t_fwd=ly.t_fwd * s, t_bwd=ly.t_bwd * s)
              for ly, s in zip(jprof.layers, scales)]
    return dataclasses.replace(jprof, layers=layers)


def _worker(delay, P, accum=(), omit=(), recompute=0):
    knobs = [jcm.StageKnobs(accum[j] if j < len(accum) else 1, omit[j] if j < len(omit) else 0)
             for j in range(P)]
    return jcm.WorkerConfig(delay, recompute, knobs)


SCHEDULES = {
    "async_p4_n3": dict(workers=[_worker(n, 4) for n in range(3)], P=4, R=40),
    "accum_omit_removed": dict(
        workers=[_worker(0, 3, accum=(2,)), _worker(1, 3, omit=(0, 1)), _worker(-1, 3)],
        P=3, R=37),
    "sync_period_2": dict(workers=[_worker(0, 1)], P=1, R=12, sync_period=2),
    "continuation": dict(workers=[_worker(n, 3, accum=(2, 1)) for n in range(2)], P=3, R=20,
                         phase=3, warmup=7),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_build_schedule_matches_reference(name):
    case = dict(SCHEDULES[name])
    jconfig = jcm.PipelineConfig(workers=case.pop("workers"))
    P, R = case.pop("P"), case.pop("R")
    want = jsched.build_schedule(jconfig, P, R, **case)
    got = schedule.build_schedule(_port_config(jconfig), P, R, **case)
    padded = schedule.pad_schedule(schedule.slice_schedule(got, 2, R - 1), R)
    want_padded = jsched.pad_schedule(jsched.slice_schedule(want, 2, R - 1), R)
    for g, w in ((got, want), (padded, want_padded)):
        for f in dataclasses.fields(w):
            a, b = getattr(g, f.name), getattr(w, f.name)
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=f.name)
            else:
                assert a == b, f.name


@pytest.mark.parametrize("profile_kind", ["uniform", "hetero"])
@pytest.mark.parametrize("budget_frac", [None, 0.3, 0.05])
def test_planner_matches_reference(profile_kind, budget_frac):
    jprof = _tiny_profile()[1] if profile_kind == "uniform" else _hetero_profile()
    prof = _port_profile(jprof)
    t_d = jplanner.default_data_interval(jprof)
    assert planner.default_data_interval(prof) == t_d
    budget = float("inf")
    if budget_frac is not None:
        budget = jplanner.plan(jprof, t_d, budget, max_workers=3, max_stages=4).memory
        budget *= budget_frac
    want = jplanner.plan(jprof, t_d, budget, max_workers=3, max_stages=4)
    got = planner.plan(prof, t_d, budget, max_workers=3, max_stages=4)
    assert tuple(got.partition.bounds) == tuple(want.partition.bounds)
    assert dataclasses.asdict(got.config) == dataclasses.asdict(want.config)
    assert got.rate == want.rate and got.memory == want.memory
    assert got.feasible == want.feasible and got.t_c == want.t_c
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)


def test_engine_rounds_match_reference():
    """Iter-Fisher with fast λ tuning under a budget whose plan uses gradient
    accumulation (T2), back-prop omission (T3) and worker removal (T4). (The
    unbounded plan is held round by round in test_torch_trainer.py.)"""
    jcfg, jprof = _tiny_profile()
    cfg = dataclasses.replace(get_config("h2o-danube-1.8b", smoke=True), num_layers=4,
                              vocab_size=32, compute_dtype="float32")
    t_d = jplanner.default_data_interval(jprof)
    budget = 0.3 * jplanner.plan(jprof, t_d, float("inf"), max_workers=3, max_stages=4).memory
    jplan = jplanner.plan(jprof, t_d, budget, max_workers=3, max_stages=4)
    bounds = list(jplan.partition.bounds)
    P, R = len(bounds) - 1, 24
    jsch = jsched.build_schedule(jplan.config, P, R)
    sch = schedule.build_schedule(_port_config(jplan.config), P, R)
    stream = make_stream(StreamConfig(kind="iid", modality="tokens", length=R, batch=2,
                                      vocab=32, seq=16, seed=5))
    np_params = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(1)))
    comp_kw = dict(method="iter_fisher", eta_lambda=100.0)

    jeng = JEngine(jstaged(jcfg, bounds), jsch, jadamw(lr=5e-3), JCompCfg(**comp_kw), lr=5e-3)
    jstate = jeng.init_state(JT.split_stage_params(jcfg, jax.tree.map(jnp.asarray, np_params),
                                                   bounds))
    _, jys = jeng.run(jstate, {k: jnp.asarray(v) for k, v in stream.items()})

    eng = FerretEngine(staged_from_transformer(cfg, bounds), sch, adamw(lr=5e-3),
                       CompensationConfig(**comp_kw), lr=5e-3)
    state = eng.init_state(T.split_stage_params(cfg, params_from_numpy(np_params), bounds))
    final, ys = eng.run(state, {k: torch.from_numpy(v) for k, v in stream.items()})

    assert not sch.process.all() and (sch.pop_slot >= 0).sum() > 0  # T4 dropped items
    for key in ("loss", "acc", "admitted", "tau_mean"):
        np.testing.assert_allclose(ys[key].numpy(), np.asarray(jys[key]), rtol=1e-4, atol=1e-4,
                                   err_msg=key)
    np.testing.assert_allclose(ys["lam"].numpy(), np.asarray(jys["lam"]), rtol=0, atol=1e-5)
    assert np.ptp(np.asarray(jys["lam"])) > 1e-4  # λ tuning really moved λ
    assert final.geometry == schedule.RingGeometry(sch.ring_size, sch.delta_ring)
