"""The port's CUDA kernels and its trainer on the card (marker ``cuda``).

These need a CUDA device and skip without one. They import no JAX, so they
also run where only the port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the kernels round every elementwise operation like their plain
versions (rtol 1e-6; expected exact); s1 and s2 are sums in another order,
held to 1e-5 of the sum of |terms|. The trainer on the card and on the CPU
are held to 1e-3 in loss and 1e-5 in λ (fp32 both; sums run in other orders
on the card and 48 rounds of Adam carry that).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.compensation import CompensationConfig
from repro_torch.core.ferret import FerretConfig, FerretTrainer
from repro_torch.kernels import ops, packing
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_config
from repro_torch.ocl.streams import StreamConfig, make_stream

pytestmark = pytest.mark.cuda

RAGGED_TREES = [
    {"w": (33, 17), "b": (5,), "scale": ()},
    {"a": (3, 5, 7), "b": (1,), "c": (256,), "d": (4097,)},
]
ALPHA = 0.9


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tree(shapes, seed, scale=1.0, lead=()):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(np.asarray(rng.normal(size=lead + s) * scale, np.float32))
            for k, s in shapes.items()}


def _to(tree, device):
    return {k: v.to(device) for k, v in tree.items()}


@pytest.mark.parametrize("tau", [0, 1, 3])
@pytest.mark.parametrize("idx", range(len(RAGGED_TREES)))
def test_kernels_match_plain_versions(cuda, idx, tau):
    g = _tree(RAGGED_TREES[idx], idx, 1.0)
    d = _tree(RAGGED_TREES[idx], idx + 1, 0.01, lead=(tau,))
    vr, va = _tree(RAGGED_TREES[idx], idx + 2, 0.1), _tree(RAGGED_TREES[idx], idx + 3, 0.01)
    lam = torch.tensor(0.3)
    before = dict(packing.LAUNCHES)
    got = ops.iter_fisher_compensate_tree(_to(g, cuda), _to(d, cuda), lam.to(cuda))
    want = ops.iter_fisher_compensate_tree(g, d, lam)
    for k in g:
        np.testing.assert_allclose(got[k].cpu().numpy(), want[k].numpy(), rtol=1e-6, atol=0)
    d1 = {k: v[-1] for k, v in _tree(RAGGED_TREES[idx], idx + 4, 0.01, lead=(1,)).items()}
    out = ops.iter_fisher_stats_tree(*(_to(t, cuda) for t in (g, d1, vr, va)), ALPHA)
    ref = ops.iter_fisher_stats_tree(g, d1, vr, va, ALPHA)
    for i in (0, 1):
        for k in g:
            np.testing.assert_allclose(out[i][k].cpu().numpy(), ref[i][k].numpy(),
                                       rtol=1e-6, atol=0)
    s1_scale = sum(((1 - ALPHA) * (g[k].double() - vr[k]) * va[k]).abs().sum() for k in g)
    s2_scale = sum((va[k].double() ** 2).sum() for k in g)
    assert out[2].device.type == "cuda" and out[2].dim() == 0
    assert abs(float(out[2]) - float(ref[2])) <= 1e-5 * float(s1_scale)
    assert abs(float(out[3]) - float(ref[3])) <= 1e-5 * float(s2_scale)
    assert packing.LAUNCHES["compensate_packed"] == before["compensate_packed"] + (tau > 0)
    assert packing.LAUNCHES["stats_packed"] == before["stats_packed"] + 1


def test_stats_are_the_same_on_every_run(cuda):
    g, d, vr, va = (torch.randn(3 * 2**20, device=cuda) for _ in range(4))
    first = packing.stats_packed(g, d, vr, va, ALPHA)
    for _ in range(3):
        again = packing.stats_packed(g, d, vr, va, ALPHA)
        assert float(again[2]) == float(first[2]) and float(again[3]) == float(first[3])


def test_wrappers_check_their_inputs(cuda):
    g = torch.zeros(packing.BLOCK, device=cuda)
    d = torch.zeros(2, packing.BLOCK, device=cuda)
    lam = torch.zeros((), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        packing.compensate_packed(g.double(), d, lam)
    with pytest.raises(ValueError, match="contiguous"):
        packing.compensate_packed(g, torch.zeros(packing.BLOCK, 2, device=cuda).T, lam)
    with pytest.raises(ValueError, match="multiple of 4"):
        packing.stats_packed(g[:6], g[:6], g[:6], g[:6], ALPHA)


def _small():
    cfg = dataclasses.replace(get_config("h2o-danube-1.8b", smoke=True), num_layers=4,
                              vocab_size=32, compute_dtype="float32")
    fc = FerretConfig(budget_bytes=float("inf"), lr=5e-3, max_workers=3, max_stages=4,
                      compensation=CompensationConfig(method="iter_fisher", eta_lambda=1.0))
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    stream = make_stream(StreamConfig(kind="iid", modality="tokens", length=44, batch=2,
                                      vocab=32, seq=16, seed=0))
    return cfg, fc, params, stream


def test_trainer_on_the_card_matches_the_cpu(cuda):
    cfg, fc, params, stream = _small()
    packing.reset_launches()
    card = FerretTrainer(cfg, fc, 2, 16).run_stream(params, stream, segment_rounds=16)
    assert min(packing.LAUNCHES.values()) > 0
    cpu = FerretTrainer(cfg, fc, 2, 16, device="cpu").run_stream(params, stream,
                                                                segment_rounds=16)
    np.testing.assert_allclose(card.losses, cpu.losses, rtol=0, atol=1e-3)
    np.testing.assert_allclose(card.lam_curve, cpu.lam_curve, rtol=0, atol=1e-5)


def test_segments_equal_one_run_bit_for_bit_on_the_card(cuda):
    cfg, fc, params, stream = _small()
    tr = FerretTrainer(cfg, fc, 2, 16)
    one = tr.run_stream(params, stream, segment_rounds=64)
    seg = tr.run_stream(params, stream, segment_rounds=16)
    np.testing.assert_array_equal(seg.losses, one.losses)
    np.testing.assert_array_equal(seg.lam_curve, one.lam_curve)
