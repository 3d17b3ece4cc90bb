"""The port's mamba2 slice on the CPU vs the JAX package on the same inputs.

Inputs are made with numpy from a seed and handed to both frameworks; the
weights come from ``repro.models.transformer.init_params`` and are bridged.
Tolerances (all fp32):
- the scan's values against the Pallas kernel (interpret mode) and the jnp
  reference within rtol/atol 3e-5, as ``tests/test_kernels.py`` holds the
  two JAX versions; against the token-by-token numpy recurrence 1e-4;
- the six gradients of the scan against ``jax.grad`` within rtol/atol 1e-4
  (sums over positions and heads in other orders);
- mixer and model values within 1e-5 and 2e-4 (logits), gradients within
  1e-4 of the largest gradient of their leaf, as ``tests/test_torch_model.py``;
- the trainer with the tolerances of ``tests/test_torch_trainer.py``:
  losses 1e-4, λ 1e-5, online accuracy 0.02, final weights 1e-4 relative L2
  per leaf. It trains at lr 1e-3, not the dense test's 5e-3: at 5e-3 the
  mamba2 smoke run is chaotic (a nudge of its weights by one fp32 rounding
  moves its losses by more than these tolerances within 48 rounds;
  ``scripts/mamba2_chaos_witness.py`` measures it), so no fixed tolerance
  could tell a fault from rounding. Within the port, a run in segments
  equals one run bit for bit.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke_cfg
from repro.core.compensation import CompensationConfig as JCompCfg
from repro.core.ferret import FerretConfig as JFerretConfig
from repro.core.ferret import FerretTrainer as JFerretTrainer
from repro.core.profiler import analytic_profile as janalytic
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan_pallas
from repro.models import ssm as jssm
from repro.models import transformer as JT
from repro.ocl.streams import StreamConfig, make_stream
from repro_torch.bridge import params_from_numpy, to_numpy
from repro_torch.core import planner
from repro_torch.core.compensation import CompensationConfig
from repro_torch.core.ferret import FerretConfig, FerretTrainer
from repro_torch.core.profiler import LayerProfile, ModelProfile, analytic_profile
from repro_torch.kernels import ops, ref
from repro_torch.models import ssm
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_config

ARCH = "mamba2-780m"


def _scan_inputs(nc=3, seed=0, b=2, h=3, p=8, n=16, Q=8):
    rng = np.random.default_rng(seed)
    l = nc * Q
    f = np.float32
    return dict(
        x=rng.normal(size=(b, l, h, p)).astype(f),
        dt=rng.uniform(0.001, 0.2, size=(b, l, h)).astype(f),
        A=(-rng.uniform(0.5, 2.0, size=(h,))).astype(f),
        B=rng.normal(size=(b, l, n)).astype(f),
        C=rng.normal(size=(b, l, n)).astype(f),
        s0=(rng.normal(size=(b, h, p, n)) * 0.1).astype(f),
        dy=rng.normal(size=(b, l, h, p)).astype(f),
        dS=rng.normal(size=(b, h, p, n)).astype(f),
        Q=Q,
    )


ARGS = ("x", "dt", "A", "B", "C")


def _t(d, *keys):
    return [torch.from_numpy(d[k]) for k in keys]


def _j(d, *keys):
    return [jnp.asarray(d[k]) for k in keys]


@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("nc", [2, 4])
def test_scan_matches_pallas_kernel_and_reference(nc, with_s0):
    d = _scan_inputs(nc, seed=nc)
    s0 = d["s0"] if with_s0 else None
    y, final = ref.ssd_scan_ref(*_t(d, *ARGS), d["Q"], None if s0 is None else torch.from_numpy(s0))
    js0 = None if s0 is None else jnp.asarray(s0)
    for want in (ssd_scan_pallas(*_j(d, *ARGS), d["Q"], js0, interpret=True),
                 jref.ssd_scan_ref(*_j(d, *ARGS), d["Q"], js0)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want[0]), rtol=3e-5, atol=3e-5)
        np.testing.assert_allclose(final.numpy(), np.asarray(want[1]), rtol=3e-5, atol=3e-5)


def test_ragged_length_through_ops_matches_reference_ops():
    from repro.kernels import ops as jops

    d = _scan_inputs(3, seed=5)
    cut = {k: (v[:, :21] if k in ("x", "dt", "B", "C") else v) for k, v in d.items()}
    y, final = ops.ssd_scan(*_t(cut, *ARGS), d["Q"])
    wy, wfinal = jops.ssd_scan(*_j(cut, *ARGS), d["Q"])
    assert y.shape == (2, 21, 3, 8)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(wy), rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(final.detach().numpy(), np.asarray(wfinal), rtol=3e-5, atol=3e-5)


def test_scan_matches_sequential_recurrence():
    """Chunked scan == exact token-by-token recurrence (ground truth)."""
    d = _scan_inputs(4, seed=1)
    x, dt, A, B, C = (d[k].astype(np.float64) for k in ARGS)
    b, slen, h, p = x.shape
    s = np.zeros((b, h, p, B.shape[-1]))
    ys = np.zeros_like(x)
    for t in range(slen):
        s = s * np.exp(dt[:, t] * A)[:, :, None, None] + np.einsum(
            "bh,bhp,bn->bhpn", dt[:, t], x[:, t], B[:, t])
        ys[:, t] = np.einsum("bhpn,bn->bhp", s, C[:, t])
    y, final = ref.ssd_scan_ref(*_t(d, *ARGS), d["Q"])
    np.testing.assert_allclose(y.numpy(), ys, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(final.numpy(), s, rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def scan_grads():
    """jax.grad of ⟨y, dy⟩ + ⟨final, dS⟩ through the jnp reference."""
    d = _scan_inputs(3, seed=7)

    def f(x, dt, A, B, C, s0):
        y, s = jref.ssd_scan_ref(x, dt, A, B, C, d["Q"], s0)
        return jnp.sum(y * d["dy"]) + jnp.sum(s * d["dS"])

    want = jax.grad(f, argnums=tuple(range(6)))(*_j(d, *ARGS, "s0"))
    return d, [np.asarray(w) for w in want]


GRAD_NAMES = ("dx", "ddt", "dA", "dB", "dC", "ds0")


@pytest.mark.parametrize("route", ["formulas", "autograd_of_plain", "autograd_function"])
def test_scan_gradients_match_jax_grad(scan_grads, route):
    d, want = scan_grads
    x, dt, A, B, C, s0, dy, dS = _t(d, *ARGS, "s0", "dy", "dS")
    Q = d["Q"]
    if route == "formulas":
        sb = ref.ssd_scan_fwd_ref(x, dt, A, B, C, Q, s0)[2]
        got = ref.ssd_scan_bwd_ref(x, dt, A, B, C, Q, sb, dy, dS)
    else:
        leaves = [t.clone().requires_grad_(True) for t in (x, dt, A, B, C, s0)]
        fn = ref.ssd_scan_ref if route == "autograd_of_plain" else ops.ssd_scan
        y, final = fn(*leaves[:5], Q, leaves[5])
        torch.autograd.backward([y, final], [dy, dS])
        got = [leaf.grad for leaf in leaves]
    for g, w, name in zip(got, want, GRAD_NAMES):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-4, atol=1e-4, err_msg=name)


def test_unused_final_state_seeds_no_gradient():
    d = _scan_inputs(2, seed=9)
    x, dt, A, B, C, dy = _t(d, *ARGS, "dy")
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, A, B, C)]
    y, _ = ops.ssd_scan(*leaves, d["Q"])
    y.backward(dy)
    sb = ref.ssd_scan_fwd_ref(x, dt, A, B, C, d["Q"])[2]
    want = ref.ssd_scan_bwd_ref(x, dt, A, B, C, d["Q"], sb, dy, None)
    for leaf, w in zip(leaves, want):
        np.testing.assert_array_equal(leaf.grad.numpy(), w.numpy())


# ---------------------------------------------------------------------------
# The mixer and the model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    jcfg = smoke_cfg(ARCH)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), compute_dtype="float32")
    np_params = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, cfg, np_params


def test_registry_shapes_and_init_match_reference(model):
    jcfg, cfg, np_params = model
    mine = to_numpy(T.init_params(cfg, torch.Generator().manual_seed(0)))
    flat_mine = jax.tree_util.tree_flatten_with_path(mine)[0]
    flat_ref = jax.tree_util.tree_flatten_with_path(np_params)[0]
    assert [p for p, _ in flat_mine] == [p for p, _ in flat_ref]
    for (path, a), (_, b) in zip(flat_mine, flat_ref):
        name = path[-1].key
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if name in ("D",) or "norm" in name or name.startswith("conv_b") or name == "dt_bias":
            np.testing.assert_array_equal(a, b)  # constant inits
        elif name == "A_log":
            assert (a >= 0).all() and (a < np.log(16.0)).all()
        else:  # same fan-in scaled distribution (bits differ by design)
            assert np.std(a) == pytest.approx(np.std(b), rel=0.3), path


def _mixer_weights(np_params, layer=1):
    return {k: v[layer] for k, v in np_params["blocks"]["ssm"].items()}


def test_mixer_values_and_grads_match_reference(model):
    jcfg, cfg, np_params = model
    w = _mixer_weights(np_params)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 20, cfg.d_model)).astype(np.float32)  # ragged: 20 = 2.5 chunks
    cot = rng.normal(size=(2, 20, cfg.d_model)).astype(np.float32)

    def jf(p, xx):
        return jnp.sum(jssm.ssm_mixer_train(jcfg, p, xx) * cot)

    jw = jax.tree.map(jnp.asarray, w)
    want = jssm.ssm_mixer_train(jcfg, jw, jnp.asarray(x))
    jgrads, jgx = jax.grad(jf, argnums=(0, 1))(jw, jnp.asarray(x))
    tw = {k: v.requires_grad_(True) for k, v in params_from_numpy(w).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    got = ssm.ssm_mixer_train(cfg, tw, tx)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    got.backward(torch.from_numpy(cot))
    for k, v in tw.items():
        b = np.asarray(jgrads[k])
        np.testing.assert_allclose(v.grad.numpy(), b, rtol=0,
                                   atol=1e-4 * np.abs(b).max() + 1e-12, err_msg=k)
    b = np.asarray(jgx)
    np.testing.assert_allclose(tx.grad.numpy(), b, rtol=0, atol=1e-4 * np.abs(b).max())


@pytest.mark.parametrize("case", ["rms_norm_gated", "causal_depthwise_conv"])
def test_mixer_pieces_match_reference(case):
    rng = np.random.default_rng(4)
    y = rng.normal(size=(2, 12, 32)).astype(np.float32)
    if case == "rms_norm_gated":
        z = rng.normal(size=(2, 12, 32)).astype(np.float32)
        w = rng.normal(size=(32,)).astype(np.float32)
        got = ssm.rms_norm_gated(*map(torch.from_numpy, (y, z, w)), 1e-6)
        want = jssm.rms_norm_gated(*map(jnp.asarray, (y, z, w)), 1e-6)
    else:
        w = rng.normal(size=(4, 32)).astype(np.float32)
        b = rng.normal(size=(32,)).astype(np.float32)
        got = ssm.causal_depthwise_conv(*map(torch.from_numpy, (y, w, b)))
        want = jssm.causal_depthwise_conv(*map(jnp.asarray, (y, w, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _batch(vocab, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, size=(b, s)).astype(np.int32),
            "labels": rng.integers(0, vocab, size=(b, s)).astype(np.int32)}


def test_loss_and_grads_match_value_and_grad(model):
    jcfg, cfg, np_params = model
    jp = jax.tree.map(jnp.asarray, np_params)
    tp = params_from_numpy(np_params)
    batch = _batch(cfg.vocab_size, seed=3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: JT.loss_fn(jcfg, p, jb), has_aux=True)(jp)
    logits, _ = T.forward(cfg, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(JT.forward(jcfg, jp, jb)[0]),
                               atol=2e-4, rtol=0)
    for v in jax.tree.leaves(tp):
        v.requires_grad_(True)
    loss, met = T.loss_fn(cfg, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert float(met["acc"]) == pytest.approx(float(jmet["acc"]), abs=1.0 / 32)
    flat_t = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.grad.numpy(), tp, is_leaf=torch.is_tensor))[0]
    flat_j = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jgrads))[0]
    assert [p for p, _ in flat_t] == [p for p, _ in flat_j]
    for (path, a), (_, b) in zip(flat_t, flat_j):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max() + 1e-12,
                                   err_msg=str(path))


def test_stage_split_merge_roundtrip_matches_reference(model):
    jcfg, cfg, np_params = model
    jp, tp = jax.tree.map(jnp.asarray, np_params), params_from_numpy(np_params)
    bounds = [0, 1, 2]
    stages = T.split_stage_params(cfg, tp, bounds)
    for s, js in zip(stages, JT.split_stage_params(jcfg, jp, bounds)):
        assert jax.tree.structure(jax.tree.map(np.asarray, js)) == \
            jax.tree.structure(to_numpy(s))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab_size, seed=4).items()}
    x = None
    for j in range(2):
        x = T.stage_forward(cfg, stages[j], x, j, 2, bounds, batch)
    np.testing.assert_array_equal(x.detach().numpy(), T.forward(cfg, tp, batch)[0].detach().numpy())
    merged = to_numpy(T.merge_stage_params(cfg, stages))
    for a, b in zip(jax.tree.leaves(merged), jax.tree.leaves(np_params)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------

COMP = dict(method="iter_fisher", eta_lambda=1.0)
LR = 1e-3  # see the module docstring


def _stream(length, seed=0):
    return make_stream(StreamConfig(kind="iid", modality="tokens", length=length, batch=2,
                                    vocab=32, seq=16, seed=seed))


@pytest.fixture(scope="module")
def setup():
    jcfg = smoke_cfg(ARCH, vocab_size=32)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), vocab_size=32,
                              compute_dtype="float32")
    np_params = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(0)))
    jprof = janalytic(jcfg, 2, 16)
    prof = ModelProfile([LayerProfile(**dataclasses.asdict(ly)) for ly in jprof.layers],
                        jprof.embed_bytes, 2, 16)
    return jcfg, cfg, np_params, jprof, prof


def _port(cfg, prof):
    fc = FerretConfig(budget_bytes=float("inf"), lr=LR, max_workers=3, max_stages=4,
                      compensation=CompensationConfig(**COMP))
    return FerretTrainer(cfg, fc, batch=2, seq=16, profile=prof, device="cpu")


def test_profile_and_plan_match_reference(setup):
    """The analytic profile's sizes are the reference's (its times use the
    H100's data-sheet roofline, the reference's its own); on one profile
    the planner picks the same plan."""
    jcfg, cfg, _, jprof, prof = setup
    mine = analytic_profile(cfg, 2, 16)
    for a, b in zip(mine.layers, jprof.layers):
        assert (a.w_bytes, a.a_bytes, a.a_internal_bytes) == \
            (b.w_bytes, b.a_bytes, b.a_internal_bytes)
    assert mine.embed_bytes == jprof.embed_bytes
    from repro.core import planner as jplanner

    t_d = planner.default_data_interval(prof)
    got = planner.plan(prof, t_d, float("inf"), max_workers=3, max_stages=4)
    want = jplanner.plan(jprof, t_d, float("inf"), max_workers=3, max_stages=4)
    assert tuple(got.partition.bounds) == tuple(want.partition.bounds)
    assert got.memory == want.memory and got.rate == want.rate


def test_trainer_matches_reference(setup):
    jcfg, cfg, np_params, jprof, prof = setup
    stream = _stream(48)
    jfc = JFerretConfig(budget_bytes=float("inf"), lr=LR, max_workers=3, max_stages=4,
                        compensation=JCompCfg(**COMP))
    jtr = JFerretTrainer(jcfg, jfc, 2, 16, profile=jprof)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)  # raw-dict stream
        want = jtr.run_stream(jax.tree.map(jnp.asarray, np_params), stream, segment_rounds=16)
    tr = _port(cfg, prof)
    got = tr.run_stream(params_from_numpy(np_params), stream, segment_rounds=16)
    assert tuple(tr.plan.partition.bounds) == tuple(jtr.plan.partition.bounds)
    assert got.rounds == want.rounds == 48
    np.testing.assert_allclose(got.losses, want.losses, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.lam_curve, want.lam_curve, rtol=0, atol=1e-5)
    assert abs(got.online_acc - want.online_acc) <= 0.02
    assert got.admitted_frac == want.admitted_frac
    for path, v in jax.tree_util.tree_flatten_with_path(
            jax.tree.map(np.asarray, jtr.final_params))[0]:
        node = tr.final_params
        for key in path:
            node = node[key.key]
        assert np.linalg.norm(node.numpy() - v) <= 1e-4 * np.linalg.norm(v) + 1e-7, path


def test_segments_equal_one_run_bit_for_bit(setup):
    _, cfg, np_params, _, prof = setup
    stream = _stream(40, seed=2)  # 40 = 2·16 + 8: the last segment is ragged and padded
    tr = _port(cfg, prof)
    one = tr.run_stream(params_from_numpy(np_params), stream, segment_rounds=64)
    one_params = to_numpy(tr.final_params)
    seg = tr.run_stream(params_from_numpy(np_params), stream, segment_rounds=16)
    np.testing.assert_array_equal(seg.losses, one.losses)
    np.testing.assert_array_equal(seg.lam_curve, one.lam_curve)
    assert np.isfinite(one.losses).all() and one.rounds == 40
    for a, b in zip(jax.tree.leaves(to_numpy(tr.final_params)), jax.tree.leaves(one_params)):
        np.testing.assert_array_equal(a, b)
