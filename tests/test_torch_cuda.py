"""Tests that need the CUDA device: the hand-written kernels (K1, the bank
scan, and K2, the tile scan) against their plain PyTorch versions. They skip on a machine without a GPU.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed; there the JAX-importing ``tests/conftest.py``
must be left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from cslam_tpu_torch.ops import nns


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bank_scan_matches_plain_version_on_card(dtype):
    """Bit for bit (same summation order and roundings): ties across bank
    splits, n < k, k = 128, a batch that is not a multiple of 32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.default_rng(1)
    bank = torch.from_numpy(_unit(rng.standard_normal((20000, 64)))).cuda()
    bank[9000] = bank[10]
    q = torch.from_numpy(rng.standard_normal((70, 64)).astype(
        np.float32)).cuda()
    q[4] = bank[10]
    b = bank.to(dtype)
    for n, k in ((19000, 10), (3, 8), (20000, 128)):
        before = nns.launches
        gv, gi = nns.cosine_topk_scan(b, n, q, k)
        assert nns.launches == before + 1
        rv, ri = nns.cosine_topk_scan_ref(b, n, q, k)
        assert torch.equal(gi, ri)
        assert torch.equal(gv, rv)
    assert gi[4, :2].tolist() == [10, 9000]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tile_scan_matches_plain_version_on_card(dtype):
    """K2 bit for bit against its plain version (same summation order and
    roundings, then one multiply by the row's inverse norm): ties across
    splits, n < k with its (-inf, 0) tail, a batch that is not a multiple
    of 32, non-unit rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.default_rng(2)
    rows = rng.standard_normal((20000, 64)) * rng.uniform(0.5, 2.0,
                                                          (20000, 1))
    bank = torch.from_numpy(rows.astype(np.float32)).cuda()
    bank[9000] = bank[10]
    inv = 1.0 / bank.norm(dim=1)
    q = torch.from_numpy(rng.standard_normal((70, 64)).astype(
        np.float32)).cuda()
    q[4] = bank[10]
    b = bank.to(dtype)
    for n, k in ((19000, 10), (3, 8), (20000, 1)):
        before = nns.tile_scan_launches
        gv, gi = nns.cosine_topk_fused(b, inv, n, q, k)
        assert nns.tile_scan_launches == before + 1
        rv, ri = nns.cosine_topk_fused_ref(b, inv, n, q, k)
        assert torch.equal(gi, ri)
        assert torch.equal(gv, rv)
        if n < k:
            assert gi[:, n:].eq(0).all() and gv[:, n:].isneginf().all()
    gv, gi = nns.cosine_topk_fused(b, inv, 19000, q, 10)
    assert gi[4, :2].tolist() == [10, 9000]


def _adversarial(case, rng, N=3000, D=64):
    """Rows that stress the tensor-core screen: near-ties (one base row plus
    1e-7-scale noise: hundreds of rows within eps of the k-th) or identical
    rows (every row survives the screen, the worst case)."""
    base = rng.standard_normal(D)
    if case == "near_ties":
        rows = base + 1e-7 * rng.standard_normal((N, D))
    else:
        rows = np.tile(base, (N, 1))
    return torch.from_numpy(rows.astype(np.float32)).cuda(), base


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["bank_scan", "tile_scan"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["near_ties", "identical_rows"])
@pytest.mark.parametrize("B", [1, 8, 16, 40])
def test_screen_adversarial_cases_match_plain_version_on_card(kernel, dtype,
                                                              case, B):
    """Both paths (B < 16: exact dots; B >= 16: tensor-core screen and exact
    rescore) bit for bit against the plain version where the screen's error
    bound matters most."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.default_rng(3)
    bank, base = _adversarial(case, rng)
    q = torch.from_numpy(rng.standard_normal((B, 64)).astype(
        np.float32)).cuda()
    q[0] = torch.from_numpy(base.astype(np.float32)).cuda()
    b = bank.to(dtype)
    n = 2900
    if kernel == "bank_scan":
        got = nns.cosine_topk_scan(b, n, q, 10)
        want = nns.cosine_topk_scan_ref(b, n, q, 10)
    else:
        inv = 1.0 / bank.norm(dim=1)
        got = nns.cosine_topk_fused(b, inv, n, q, 10)
        want = nns.cosine_topk_fused_ref(b, inv, n, q, 10)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])
    if case == "identical_rows":   # ties go to the lowest rows
        assert got[1][0].tolist() == list(range(10))
