"""The port's optimizers and gradient compensation vs the JAX package.

Random fp32 trees made with numpy from a seed go through both. Tolerances:
1e-6 relative plus 1e-6·max|reference| absolute — fp32 elementwise work
where XLA may contract a multiply-add and ``pow`` may differ by an ulp;
λ and its statistics within 1e-6 relative (sums taken in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compensation as jcomp
from repro.optim import optimizers as jopt
from repro_torch.core import compensation as comp
from repro_torch.optim import optimizers as opt

SHAPES = {"w": (33, 17), "b": (5,), "blocks": {"wq": (2, 8, 8), "norm": (2, 8)}}


def _np_tree(seed, scale=1.0, lead=()):
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in SHAPES.items():
        if isinstance(s, dict):
            out[k] = {n: (rng.normal(size=lead + t) * scale).astype(np.float32)
                      for n, t in s.items()}
        else:
            out[k] = (rng.normal(size=lead + s) * scale).astype(np.float32)
    return out


def _t(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got_tree, want_tree):
    got = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), got_tree, is_leaf=torch.is_tensor))
    want = jax.tree.leaves(jax.tree.map(np.asarray, want_tree))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * (np.abs(b).max() + 1e-30))


OPTIMIZERS = {
    "adamw": dict(lr=1e-2),
    "adamw_decay_clip": dict(lr=1e-2, weight_decay=0.1, grad_clip=0.5),
    "sgd": dict(lr=1e-2),
    "sgd_momentum": dict(lr=1e-2, momentum=0.9),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_reference_over_steps(name):
    kind = "adamw" if name.startswith("adamw") else "sgd"
    mine = getattr(opt, kind)(**OPTIMIZERS[name])
    theirs = getattr(jopt, kind)(**OPTIMIZERS[name])
    params = _np_tree(0)
    tp, jp = _t(params), _j(params)
    ts, js = mine.init(tp), theirs.init(jp)
    for step in range(6):
        grads = _np_tree(100 + step, scale=0.1)
        tp, ts = mine.update(tp, _t(grads), ts)
        jp, js = theirs.update(jp, _j(grads), js)
        _close(tp, jp)
    if kind == "adamw":
        assert int(ts.count) == int(js.count) == 6
        _close(ts.mu, js.mu)
        _close(ts.nu, js.nu)


METHODS = ["none", "step_aware", "gap_aware", "fisher", "iter_fisher"]


@pytest.mark.parametrize("method", METHODS)
def test_compensation_method_matches_reference(method):
    cfg_kw = dict(method=method, lam0=0.3, eta_lambda=1e-2)
    cfg, jcfg = comp.CompensationConfig(**cfg_kw), jcomp.CompensationConfig(**cfg_kw)
    params = _np_tree(1)
    grad = _np_tree(2, scale=0.5)
    deltas = _np_tree(3, scale=0.01, lead=(3,))
    state, jstate = comp.init_state(_t(params), cfg), jcomp.init_state(_j(params), jcfg)
    tau = np.int32(2)
    state, got = comp.compensate(cfg, state, _t(grad), _t(deltas), lr=1e-2,
                                 tau=torch.tensor(tau))
    jstate, want = jcomp.compensate(jcfg, jstate, _j(grad), _j(deltas), lr=1e-2,
                                    tau=jnp.asarray(tau))
    _close(got, want)
    np.testing.assert_allclose(float(state.lam), float(jstate.lam), rtol=1e-6)
    if method == "iter_fisher":
        _close(state.v_r, jstate.v_r)
        _close(state.v_a, jstate.v_a)
        assert int(state.steps) == int(jstate.steps) == 1
    else:
        assert float(state.lam) == pytest.approx(0.3)


def test_lambda_tuning_tracks_reference_over_steps():
    """Alg. 1 over several stale steps: λ, v_r and v_a follow the reference,
    and λ stays a 0-d tensor (never a host float)."""
    cfg_kw = dict(method="iter_fisher", lam0=0.2, eta_lambda=5.0, alpha=0.8)
    cfg, jcfg = comp.CompensationConfig(**cfg_kw), jcomp.CompensationConfig(**cfg_kw)
    params = _np_tree(4)
    state, jstate = comp.init_state(_t(params), cfg), jcomp.init_state(_j(params), jcfg)
    lams = []
    for step in range(5):
        grad = _np_tree(10 + step, scale=0.5)
        deltas = _np_tree(20 + step, scale=0.05, lead=(2,))
        state, got = comp.compensate(cfg, state, _t(grad), _t(deltas))
        jstate, want = jcomp.compensate(jcfg, jstate, _j(grad), _j(deltas))
        assert isinstance(state.lam, torch.Tensor) and state.lam.dim() == 0
        np.testing.assert_allclose(float(state.lam), float(jstate.lam), rtol=1e-6)
        _close(got, want)
        lams.append(float(state.lam))
    _close(state.v_r, jstate.v_r)
    _close(state.v_a, jstate.v_a)
    assert len(set(lams)) == len(lams)  # λ really moved every step


def test_fixed_lambda_mode_matches_reference():
    cfg_kw = dict(method="iter_fisher", lam0=0.25, eta_lambda=0.0)
    cfg, jcfg = comp.CompensationConfig(**cfg_kw), jcomp.CompensationConfig(**cfg_kw)
    params = _np_tree(5)
    state, jstate = comp.init_state(_t(params), cfg), jcomp.init_state(_j(params), jcfg)
    for leaf in jax.tree.leaves(state.v_r, is_leaf=torch.is_tensor):
        assert tuple(leaf.shape) == (0,)
    grad, deltas = _np_tree(6, scale=0.5), _np_tree(7, scale=0.05, lead=(3,))
    state, got = comp.compensate(cfg, state, _t(grad), _t(deltas))
    jstate, want = jcomp.compensate(jcfg, jstate, _j(grad), _j(deltas))
    _close(got, want)
    assert float(state.lam) == np.float32(0.25) and int(state.steps) == 0


def test_zero_staleness_is_identity():
    cfg = comp.CompensationConfig()
    grad = _t(_np_tree(8))
    state = comp.init_state(grad, cfg)
    empty = jax.tree.map(lambda t: t[None][:0], grad, is_leaf=torch.is_tensor)
    same_state, out = comp.compensate(cfg, state, grad, empty)
    assert out is grad and same_state is state
