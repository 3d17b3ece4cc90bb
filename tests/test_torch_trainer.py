"""``repro_torch.core.ferret.FerretTrainer.run_stream`` vs the JAX trainer.

The geometry of ``tests/test_system.py``'s ``tiny_setup`` (h2o-danube-1.8b
smoke, 4 layers, vocab 32, seq 16, batch 2), with one ``ModelProfile``
handed to both trainers so they plan the same pipeline. Losses are held to
1e-4 and λ to 1e-5 (fp32 training: matrix products sum in other orders in
XLA and PyTorch, and Adam carries that drift over the run); online
accuracy within 0.02 (an argmax can flip between near-equal logits); the
final weights within 1e-4 relative L2 per leaf.
Within the port, a run in segments equals one run bit for bit.
"""

import dataclasses
import warnings

import jax
import numpy as np
import pytest

from conftest import smoke_cfg
from repro.core.compensation import CompensationConfig as JCompCfg
from repro.core.ferret import FerretConfig as JFerretConfig
from repro.core.ferret import FerretTrainer as JFerretTrainer
from repro.core.profiler import analytic_profile as janalytic
from repro.models import transformer as JT
from repro.ocl.streams import StreamConfig, make_stream
from repro_torch.bridge import params_from_numpy
from repro_torch.core.compensation import CompensationConfig
from repro_torch.core.ferret import FerretConfig, FerretTrainer
from repro_torch.core.profiler import LayerProfile, ModelProfile
from repro_torch.models.registry import get_config

COMP = dict(method="iter_fisher", eta_lambda=1.0)


def _stream(length, seed=0):
    return make_stream(StreamConfig(kind="iid", modality="tokens", length=length, batch=2,
                                    vocab=32, seq=16, seed=seed))


@pytest.fixture(scope="module")
def setup():
    jcfg = smoke_cfg("h2o-danube-1.8b", num_layers=4, vocab_size=32)
    cfg = dataclasses.replace(get_config("h2o-danube-1.8b", smoke=True), num_layers=4,
                              vocab_size=32, compute_dtype="float32")
    np_params = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(0)))
    jprof = janalytic(jcfg, 2, 16)
    prof = ModelProfile([LayerProfile(**dataclasses.asdict(ly)) for ly in jprof.layers],
                        jprof.embed_bytes, 2, 16)
    return jcfg, cfg, np_params, jprof, prof


def _port(cfg, prof, budget=float("inf"), **kw):
    fc = FerretConfig(budget_bytes=budget, lr=5e-3, max_workers=3, max_stages=4,
                      compensation=CompensationConfig(**COMP))
    return FerretTrainer(cfg, fc, batch=2, seq=16, profile=prof, device="cpu", **kw)


def test_trainer_matches_reference(setup):
    """(A budget-bound plan with T2/T3/T4 is held round by round against the
    JAX engine in test_torch_engine.py.)"""
    jcfg, cfg, np_params, jprof, prof = setup
    stream = _stream(48)
    jfc = JFerretConfig(budget_bytes=float("inf"), lr=5e-3, max_workers=3, max_stages=4,
                        compensation=JCompCfg(**COMP))
    jtr = JFerretTrainer(jcfg, jfc, 2, 16, profile=jprof)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)  # raw-dict stream
        want = jtr.run_stream(jax.tree.map(jax.numpy.asarray, np_params), stream,
                              segment_rounds=16)
    tr = _port(cfg, prof, jfc.budget_bytes)
    got = tr.run_stream(params_from_numpy(np_params), stream, segment_rounds=16)
    assert tuple(tr.plan.partition.bounds) == tuple(jtr.plan.partition.bounds)
    assert got.memory_bytes == want.memory_bytes and got.planned_rate == want.planned_rate
    assert got.rounds == want.rounds == 48
    np.testing.assert_allclose(got.losses, want.losses, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.lam_curve, want.lam_curve, rtol=0, atol=1e-5)
    assert abs(got.online_acc - want.online_acc) <= 0.02
    assert got.admitted_frac == want.admitted_frac
    assert got.empirical_rate == pytest.approx(want.empirical_rate, rel=1e-12)
    for k, v in jax.tree_util.tree_flatten_with_path(
            jax.tree.map(np.asarray, jtr.final_params))[0]:
        node = tr.final_params
        for key in k:
            node = node[key.key]
        # relative L2 per leaf: Adam can move an element whose gradient is
        # near zero by up to lr on a sign flip, so elementwise is no scale
        assert np.linalg.norm(node.numpy() - v) <= 1e-4 * np.linalg.norm(v) + 1e-7, k


@pytest.fixture(scope="module")
def runs(setup):
    """One stream run whole and in segments of 16 (88 = 5·16 + 8: the last
    segment is ragged and padded)."""
    _, cfg, np_params, _, prof = setup
    stream = _stream(88, seed=2)
    tr = _port(cfg, prof)
    one = tr.run_stream(params_from_numpy(np_params), stream, segment_rounds=128)
    one_params = tr.final_params
    seg = tr.run_stream(params_from_numpy(np_params), stream, segment_rounds=16)
    return one, one_params, seg, tr.final_params


def test_trainer_learns(runs):
    res = runs[0]
    assert np.isfinite(res.losses).all()
    q = len(res.losses) // 4
    assert res.losses[-q:].mean() < res.losses[:q].mean()
    assert res.admitted_frac == 1.0 and res.rounds == 88


def test_segments_equal_one_run_bit_for_bit(runs):
    one, one_params, seg, seg_params = runs
    np.testing.assert_array_equal(seg.losses, one.losses)
    np.testing.assert_array_equal(seg.lam_curve, one.lam_curve)
    np.testing.assert_array_equal(seg.online_acc_curve, one.online_acc_curve)
    for k in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(seg_params[k].numpy(), one_params[k].numpy())
    for k, v in one_params["blocks"].items():
        np.testing.assert_array_equal(seg_params["blocks"][k].numpy(), v.numpy())
    assert seg.peak_buffered_rounds == 16 and one.peak_buffered_rounds == 88
