"""The port's packed Iter-Fisher kernels (plain versions, on the CPU) vs the
JAX package's Pallas kernels run in interpret mode and its jnp reference.

Inputs are made with numpy from a seed and handed to both frameworks.
Tolerances: the elementwise results are held to rtol 1e-6 plus an atol of
1e-6·max|reference| (fp32; the port rounds after every operation, XLA may
contract a multiply-add, which moves an element that nearly cancels by an
ulp of its operands); s1 and s2 are sums taken in different orders, held to
1e-6 of the sum of |terms| (s1 is a signed sum that can sit near 0, so |s1|
is no scale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import packing as jpacking
from repro.kernels import ref as jref
from repro_torch.kernels import ops, packing, ref

RAGGED_TREES = [
    {"w": (33, 17), "b": (5,), "scale": ()},
    {"w1": (128,), "w2": (64, 2), "b": (127,), "n": (129,)},
    {"a": (3, 5, 7), "b": (1,), "c": (256,), "d": (4097,)},
]
ALPHA = 0.9


def _np_tree(shapes, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: np.asarray(rng.normal(size=s) * scale, dtype=np.float32) for k, s in shapes.items()}


def _np_deltas(tree, tau, seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=(tau, *v.shape)) * 0.01).astype(np.float32)
            for k, v in tree.items()}


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def _torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("idx", range(len(RAGGED_TREES)))
def test_pack_spec_matches_reference(idx):
    tree = _np_tree(RAGGED_TREES[idx], idx)
    mine = packing.pack_spec(_torch(tree))
    theirs = jpacking.pack_spec(_jax(tree), block=packing.BLOCK)
    assert mine.offsets == theirs.offsets
    assert mine.slots == theirs.slots
    assert mine.sizes == theirs.sizes
    assert mine.shapes == theirs.shapes
    assert mine.total == theirs.total


@pytest.mark.parametrize("idx", range(len(RAGGED_TREES)))
def test_pack_matches_reference_and_roundtrips(idx):
    tree = _np_tree(RAGGED_TREES[idx], 10 + idx)
    spec = packing.pack_spec(_torch(tree))
    flat = packing.pack(spec, _torch(tree))
    want = np.asarray(jpacking.pack(jpacking.pack_spec(_jax(tree), block=packing.BLOCK),
                                    _jax(tree)))
    np.testing.assert_array_equal(flat.numpy(), want)  # gaps are zeros on both sides
    back = packing.unpack(spec, flat)
    for k, v in tree.items():
        assert back[k].dtype == torch.float32
        np.testing.assert_array_equal(back[k].numpy(), v)


@pytest.mark.parametrize("tau", [0, 1, 3])
@pytest.mark.parametrize("idx", range(len(RAGGED_TREES)))
def test_compensate_matches_pallas_interpret(idx, tau):
    tree = _np_tree(RAGGED_TREES[idx], 20 + idx)
    deltas = _np_deltas(tree, tau, 30 + idx)
    lam = np.float32(0.25)
    got = ops.iter_fisher_compensate_tree(_torch(tree), _torch(deltas), torch.tensor(lam))
    want = jpacking.compensate_tree(_jax(tree), _jax(deltas), jnp.asarray(lam),
                                    use_pallas=True, interpret=True, block=packing.BLOCK)
    for k in tree:
        ref_leaf = np.asarray(jref.iter_fisher_compensate_ref(
            jnp.asarray(tree[k]), jnp.asarray(deltas[k]), jnp.asarray(lam)))
        _close(got[k].numpy(), np.asarray(want[k]))
        _close(got[k].numpy(), ref_leaf)


@pytest.mark.parametrize("idx", range(len(RAGGED_TREES)))
def test_stats_match_pallas_interpret(idx):
    g = _np_tree(RAGGED_TREES[idx], 40 + idx)
    d = _np_tree(RAGGED_TREES[idx], 41 + idx, scale=0.01)
    vr = _np_tree(RAGGED_TREES[idx], 42 + idx, scale=0.1)
    va = _np_tree(RAGGED_TREES[idx], 43 + idx, scale=0.01)
    nvr, nva, s1, s2 = ops.iter_fisher_stats_tree(_torch(g), _torch(d), _torch(vr),
                                                  _torch(va), ALPHA)
    jvr, jva, js1, js2 = jpacking.stats_tree(_jax(g), _jax(d), _jax(vr), _jax(va), ALPHA,
                                             use_pallas=True, interpret=True,
                                             block=packing.BLOCK)
    for k in g:
        _close(nvr[k].numpy(), np.asarray(jvr[k]))
        _close(nva[k].numpy(), np.asarray(jva[k]))
    s1_scale = sum(np.abs((1 - ALPHA) * (g[k].astype(np.float64) - vr[k]) * va[k]).sum()
                   for k in g)
    s2_scale = sum((va[k].astype(np.float64) ** 2).sum() for k in g)
    assert abs(float(s1) - float(js1)) <= 1e-6 * s1_scale
    assert abs(float(s2) - float(js2)) <= 1e-6 * s2_scale
    # and per leaf against the jnp reference, summed over leaves
    per_leaf = [jref.iter_fisher_leaf_stats_ref(jnp.asarray(g[k]), jnp.asarray(d[k]),
                                                jnp.asarray(vr[k]), jnp.asarray(va[k]), ALPHA)
                for k in g]
    assert abs(float(s1) - sum(float(p[2]) for p in per_leaf)) <= 1e-6 * s1_scale
    assert abs(float(s2) - sum(float(p[3]) for p in per_leaf)) <= 1e-6 * s2_scale


@pytest.mark.parametrize("tau", [1, 3])
def test_flat_plain_versions_match_jax_flat_kernels(tau):
    """The flat buffers themselves, as the CUDA wrappers see them."""
    rng = np.random.default_rng(tau)
    total = 2 * packing.BLOCK
    g = rng.normal(size=total).astype(np.float32)
    d = (rng.normal(size=(tau, total)) * 0.01).astype(np.float32)
    vr = (rng.normal(size=total) * 0.1).astype(np.float32)
    va = (rng.normal(size=total) * 0.01).astype(np.float32)
    lam = np.float32(0.2)
    got = ref.compensate_packed_ref(torch.from_numpy(g), torch.from_numpy(d), torch.tensor(lam))
    want = jpacking.compensate_packed(jnp.asarray(g), jnp.asarray(d), jnp.asarray(lam),
                                      interpret=True, block=packing.BLOCK)
    _close(got.numpy(), np.asarray(want))
    out = ref.stats_packed_ref(*(torch.from_numpy(a) for a in (g, d[0], vr, va)), ALPHA)
    jout = jpacking.stats_packed(*(jnp.asarray(a) for a in (g, d[0], vr, va)), ALPHA,
                                 interpret=True, block=packing.BLOCK)
    _close(out[0].numpy(), np.asarray(jout[0]))
    _close(out[1].numpy(), np.asarray(jout[1]))
    s1_scale = np.abs((1 - ALPHA) * (g.astype(np.float64) - vr) * va).sum()
    assert abs(float(out[2]) - float(jout[2])) <= 1e-6 * s1_scale
    assert abs(float(out[3]) - float(jout[3])) <= 1e-6 * float((va.astype(np.float64) ** 2).sum())


def test_zero_delta_is_identity_on_odd_leaves():
    """Zero Δθ (and zero padding) is exactly the identity: atol 0."""
    tree = _np_tree(RAGGED_TREES[2], 6)
    deltas = {k: np.zeros((3, *v.shape), np.float32) for k, v in tree.items()}
    out = ops.iter_fisher_compensate_tree(_torch(tree), _torch(deltas), torch.tensor(0.7))
    for k in tree:
        np.testing.assert_array_equal(out[k].numpy(), tree[k])


def test_cpu_path_is_not_a_launch():
    tree = _torch(_np_tree(RAGGED_TREES[0], 7))
    deltas = _torch(_np_deltas(_np_tree(RAGGED_TREES[0], 7), 2, 8))
    before = dict(packing.LAUNCHES)
    ops.iter_fisher_compensate_tree(tree, deltas, torch.tensor(0.2))
    ops.iter_fisher_stats_tree(tree, {k: v[0] for k, v in deltas.items()}, tree, tree, ALPHA)
    assert packing.LAUNCHES == before


def test_wrappers_refuse_devices_without_a_kernel():
    """Only CPU tensors take the plain version; anything else launches the
    kernel (CUDA) or raises — never a silent fallback."""
    g = torch.empty(packing.BLOCK, device="meta")
    d = torch.empty(2, packing.BLOCK, device="meta")
    lam = torch.empty((), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        packing.compensate_packed(g, d, lam)
    with pytest.raises(ValueError, match="no kernel for device"):
        packing.stats_packed(g, g, g, g, ALPHA)
    with pytest.raises(ValueError, match="several devices"):
        packing.compensate_packed(torch.zeros(packing.BLOCK), d, lam)


def test_jax_interpret_mode_is_really_pallas():
    """Guard: the reference side of these tests runs the Pallas kernel (its
    trace-time launch counter moves), not the jnp fallback."""
    tree = _jax(_np_tree(RAGGED_TREES[1], 9))
    deltas = _jax(_np_deltas(_np_tree(RAGGED_TREES[1], 9), 2, 10))
    n0 = jpacking.KERNEL_LAUNCHES
    jpacking.compensate_tree(tree, deltas, jnp.asarray(0.2), use_pallas=True, interpret=True,
                             block=packing.BLOCK)
    assert jpacking.KERNEL_LAUNCHES == n0 + 1
    assert jax.default_backend() == "cpu"
