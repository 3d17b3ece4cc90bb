"""The port's CUDA kernels and its trainer on the card (marker ``cuda``).

These need a CUDA device and skip without one. They import no JAX, so they
also run where only the port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the Iter-Fisher kernels round every elementwise operation like
their plain versions (rtol 1e-6; expected exact); s1 and s2 are sums in
another order, held to 1e-5 of the sum of |terms|. The SSD kernels sum
their contractions in another order than the plain versions: f32 results
are held to 1e-4 of the largest |value| of their tensor; results written
in bf16 also to one bf16 rounding (8e-3 relative). The trainers on the card
and on the CPU are held to 1e-3 in loss and 1e-5 in λ (fp32 both; sums run
in other orders on the card and 48 rounds of Adam carry that). The mamba2
trainer runs at lr 1e-3, over two chunks: at the dense tests' 5e-3 its
smoke run is chaotic (see scripts/mamba2_chaos_witness.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.compensation import CompensationConfig
from repro_torch.core.ferret import FerretConfig, FerretTrainer
from repro_torch.kernels import ops, packing, ref, ssd_scan
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


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------

# (b, chunks, h, p, n, Q, dtype, with s0, with a final-state gradient)
SSD_CASES = [
    (2, 4, 48, 64, 128, 256, torch.bfloat16, False, False),  # the mamba2-780m path
    (1, 2, 3, 64, 128, 64, torch.float32, True, True),
    (2, 3, 4, 32, 16, 64, torch.float32, False, True),
    (2, 2, 5, 64, 128, 128, torch.bfloat16, True, True),
    (1, 1, 2, 16, 64, 256, torch.float32, True, False),
]


def _ssd_inputs(case, device, seed=0):
    b, nc, h, p, n, Q, dtype, with_s0, with_df = case
    rng = np.random.default_rng(seed)
    l = nc * Q

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device=device, dtype=dt)

    x = t(rng.normal(size=(b, l, h, p)), dtype)
    dt = t(rng.uniform(0.001, 0.1, size=(b, l, h)))
    A = t(-rng.uniform(0.5, 2.0, size=(h,)))
    B = t(rng.normal(size=(b, l, n)) / np.sqrt(n), dtype)
    C = t(rng.normal(size=(b, l, n)) / np.sqrt(n), dtype)
    s0 = t(rng.normal(size=(b, h, p, n)) * 0.1) if with_s0 else None
    dy = t(rng.normal(size=(b, l, h, p)), dtype)
    df = t(rng.normal(size=(b, h, p, n))) if with_df else None
    return (x, dt, A, B, C, Q, s0), dy, df


def _close(got, want, name, bf16=False):
    """Within 1e-4 of the largest |value| (f32 sums in another order); if
    written in bf16 by both, also one bf16 rounding (8e-3 relative) apart."""
    assert got.dtype == want.dtype and got.shape == want.shape, name
    got, want = got.float(), want.float()
    scale = float(want.abs().max())
    err = (got - want).abs()
    tol = 1e-4 * scale + (8e-3 * want.abs() if bf16 else 0.0)
    assert bool((err <= tol).all()), f"{name}: max |err| {float(err.max())} at scale {scale}"


@pytest.mark.parametrize("idx", range(len(SSD_CASES)))
def test_ssd_kernels_match_plain_versions(cuda, idx):
    case = SSD_CASES[idx]
    bf16 = case[6] == torch.bfloat16
    (x, dt, A, B, C, Q, s0), dy, df = _ssd_inputs(case, cuda)
    before = dict(ssd_scan.LAUNCHES)
    got = ssd_scan.ssd_scan_fwd(x, dt, A, B, C, Q, s0)
    want = ref.ssd_scan_fwd_ref(x, dt, A, B, C, Q, s0)
    for g, w, name in zip(got, want, ("y", "final", "states_before")):
        _close(g, w, name, bf16=bf16 and name == "y")
    sb = want[2]
    gb = ssd_scan.ssd_scan_bwd(x, dt, A, B, C, Q, sb, dy, df)
    wb = ref.ssd_scan_bwd_ref(x, dt, A, B, C, Q, sb, dy, df)
    for g, w, name in zip(gb, wb, ("dx", "ddt", "dA", "dB", "dC", "ds0")):
        _close(g, w, name, bf16=bf16 and name in ("dx", "dB", "dC"))
    torch.cuda.synchronize()
    assert ssd_scan.LAUNCHES["ssd_scan_fwd"] == before["ssd_scan_fwd"] + 1
    assert ssd_scan.LAUNCHES["ssd_scan_bwd"] == before["ssd_scan_bwd"] + 1


def test_ssd_autograd_function_matches_plain_gradients(cuda):
    (x, dt, A, B, C, Q, s0), dy, df = _ssd_inputs(SSD_CASES[1], cuda, seed=3)
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, A, B, C, s0)]
    y, final = ops.ssd_scan(*leaves[:5], Q, leaves[5])
    torch.autograd.backward([y, final], [dy, df])
    sb = ref.ssd_scan_fwd_ref(x, dt, A, B, C, Q, s0)[2]
    want = ref.ssd_scan_bwd_ref(x, dt, A, B, C, Q, sb, dy, df)
    for leaf, w, name in zip(leaves, want, ("dx", "ddt", "dA", "dB", "dC", "ds0")):
        _close(leaf.grad, w, name)


def test_ssd_backward_is_the_same_on_every_run(cuda):
    (x, dt, A, B, C, Q, s0), dy, df = _ssd_inputs(SSD_CASES[0], cuda, seed=1)
    y, final, sb = ssd_scan.ssd_scan_fwd(x, dt, A, B, C, Q, s0)
    first = ssd_scan.ssd_scan_bwd(x, dt, A, B, C, Q, sb, dy, df)
    again = ssd_scan.ssd_scan_bwd(x, dt, A, B, C, Q, sb, dy, df)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    assert torch.equal(ssd_scan.ssd_scan_fwd(x, dt, A, B, C, Q, s0)[0], y)


def test_ssd_wrappers_check_their_inputs(cuda):
    (x, dt, A, B, C, Q, s0), dy, df = _ssd_inputs(SSD_CASES[2], cuda)
    with pytest.raises(ValueError, match="multiple of 64"):
        ssd_scan.ssd_scan_fwd(x, dt, A, B, C, 32)
    with pytest.raises(TypeError, match="dt must be"):
        ssd_scan.ssd_scan_fwd(x, dt.double(), A, B, C, Q)
    with pytest.raises(TypeError, match="B must be"):
        ssd_scan.ssd_scan_fwd(x, dt, A, B.bfloat16(), C, Q)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan.ssd_scan_fwd(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A, B, C, Q)
    with pytest.raises(ValueError, match="head dim"):
        ssd_scan.ssd_scan_fwd(torch.zeros(*x.shape[:3], 96, device=cuda), dt, A, B, C, Q)


SSM_SEQ = 128


def _small_ssm():
    # the smoke config with a chunk the kernels take (multiples of 64) at
    # seq 128: two chunks, so the state carried across chunks is trained
    cfg = dataclasses.replace(get_config("mamba2-780m", smoke=True), ssm_chunk=64,
                              compute_dtype="float32")
    fc = FerretConfig(budget_bytes=float("inf"), lr=1e-3, max_workers=3, max_stages=4,
                      compensation=CompensationConfig(method="iter_fisher", eta_lambda=1.0))
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    stream = make_stream(StreamConfig(kind="iid", modality="tokens", length=48, batch=2,
                                      vocab=cfg.vocab_size, seq=SSM_SEQ, seed=0))
    return cfg, fc, params, stream


def test_mamba2_trainer_on_the_card_matches_the_cpu(cuda):
    cfg, fc, params, stream = _small_ssm()
    packing.reset_launches()
    ssd_scan.reset_launches()
    card = FerretTrainer(cfg, fc, 2, SSM_SEQ).run_stream(params, stream, segment_rounds=16)
    assert min(packing.LAUNCHES.values()) > 0 and min(ssd_scan.LAUNCHES.values()) > 0
    cpu = FerretTrainer(cfg, fc, 2, SSM_SEQ, device="cpu").run_stream(params, stream,
                                                                     segment_rounds=16)
    np.testing.assert_allclose(card.losses, cpu.losses, rtol=0, atol=1e-3)
    np.testing.assert_allclose(card.lam_curve, cpu.lam_curve, rtol=0, atol=1e-5)


def test_mamba2_segments_equal_one_run_bit_for_bit_on_the_card(cuda):
    cfg, fc, params, stream = _small_ssm()
    tr = FerretTrainer(cfg, fc, 2, SSM_SEQ)
    one = tr.run_stream(params, stream, segment_rounds=64)
    one_params = tr.final_params
    seg = tr.run_stream(params, stream, segment_rounds=16)
    np.testing.assert_array_equal(seg.losses, one.losses)
    np.testing.assert_array_equal(seg.lam_curve, one.lam_curve)
    for k, v in one_params["blocks"]["ssm"].items():
        assert torch.equal(tr.final_params["blocks"]["ssm"][k], v), k
