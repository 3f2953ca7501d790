"""The bank-scan kernels' tensor-core screen (``csrc/scan_tile.cuh``),
emulated on the CPU by ``cslam_tpu_torch.ops.nns.screen_ref``: MMA inputs
rounded to TF32 (ties away from zero) or bf16, products summed in float64,
and the kernels' error bound eps.

Two properties make the screen exact, and both are asserted here on seeded
adversarial inputs (near-ties, exact ties, rows scaled from 1e-3 to 1e3,
zero rows, n < k), for K1 and K2 and both bank types:

- the emulated screen stays within eps/4 of the plain values, which leaves
  the other 3 eps/4 to the tensor core's own f32 accumulation;
- every row of the exact top-k survives the filter ``s~ + eps >= tau`` at
  the tightest threshold the kernel can hold (the final k-th value).

The kernels themselves are held bit for bit against their plain versions on
the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

from cslam_tpu_torch.ops import nns
from cslam_tpu_torch.ops.topk import topk_ties_ascending
from torch_threads import one_torch_thread  # noqa: F401

N, D, B = 384, 32, 6


def _inputs(case, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, D)).astype(np.float32)
    if case == "near_ties":       # hundreds of rows within eps of the k-th
        base = rng.standard_normal(D)
        rows = base + 1e-7 * rng.standard_normal((N, D))
        q[0] = base
    elif case == "exact_ties":    # every row identical
        rows = np.tile(rng.standard_normal(D), (N, 1))
    elif case == "scaled_rows":   # norms from 1e-3 to 1e3
        rows = (rng.standard_normal((N, D))
                * np.logspace(-3, 3, N)[rng.permutation(N)][:, None])
    elif case == "zero_rows":
        rows = rng.standard_normal((N, D))
        rows[::3] = 0.0
    else:
        raise ValueError(case)
    rows = rows.astype(np.float32)
    norms = np.linalg.norm(rows, axis=1)
    inv = (1.0 / np.maximum(norms, 1e-12)).astype(np.float32)
    return torch.from_numpy(rows), torch.from_numpy(inv), torch.from_numpy(q)


def _plain(bank, n, q, inv):
    """The exact values the kernels rescore (before the query scaling)."""
    if inv is None:
        return nns._dots(nns._kernel_queries(bank, q.float()),
                         bank[:n].float())
    return nns._dots(q.float(), bank[:n].float()) * inv[:n]


@pytest.mark.parametrize("kernel", ["K1", "K2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,n,k", [("near_ties", N, 10),
                                      ("exact_ties", N, 10),
                                      ("scaled_rows", N, 8),
                                      ("zero_rows", N - 7, 10),
                                      ("scaled_rows", 5, 10)])
def test_screen_keeps_the_exact_top_k(kernel, dtype, case, n, k):
    rows, inv, q = _inputs(case, seed=len(case) + n)
    bank = rows.to(dtype)
    inv_k = inv if kernel == "K2" else None
    s_tilde, eps = nns.screen_ref(bank, n, q, inv_k)
    plain = _plain(bank, n, q, inv_k).double()
    assert bool(((s_tilde - plain).abs() <= eps / 4).all())
    vals, idx = topk_ties_ascending(plain, min(k, n))
    tau = vals[:, -1:] if n >= k else torch.full((B, 1), -float("inf"),
                                                  dtype=torch.float64)
    survivors = s_tilde + eps >= tau
    assert bool(survivors.gather(1, idx).all())
    if case == "exact_ties":      # the worst case: every row survives
        assert bool(survivors.all())


@pytest.mark.parametrize("kernel", ["K1", "K2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,n,k", [("near_ties", N, 10),
                                      ("exact_ties", N, 32),
                                      ("scaled_rows", N, 8),
                                      ("zero_rows", N - 7, 10),
                                      ("scaled_rows", 5, 10)])
def test_first_tile_seed_stays_at_or_below_the_k_th_value(kernel, dtype,
                                                          case, n, k):
    """The screen path seeds tau_q on a block's first 128-row tile from the
    lower bounds s~ - eps: lane l takes the largest over rows l, l + 32,
    l + 64 and l + 96, and the seed is the k-th largest of the 32. It must
    lie at or below the tile's k-th exact value (-inf below k rows)."""
    rows, inv, q = _inputs(case, seed=len(case) + n)
    bank = rows.to(dtype)
    inv_k = inv if kernel == "K2" else None
    s_tilde, eps = nns.screen_ref(bank, n, q, inv_k)
    m = min(128, n)
    bounds = torch.full((B, 128), -float("inf"), dtype=torch.float64)
    bounds[:, :m] = (s_tilde - eps)[:, :m]
    lane_max = bounds.view(B, 4, 32).amax(1)
    seed = lane_max.sort(1, descending=True).values[:, k - 1]
    if m < k:
        assert bool(seed.isneginf().all())
        return
    plain = _plain(bank, n, q, inv_k).double()[:, :m]
    assert bool((seed <= plain.topk(k, dim=1).values[:, -1]).all())
    assert bool(seed.isfinite().all())


def test_screen_error_is_a_small_share_of_eps_on_random_rows():
    """On plain random rows the emulated TF32 screen uses far less than
    eps/4: the bound is for the worst case of the rounding."""
    rows, _, q = _inputs("scaled_rows", seed=3)
    s_tilde, eps = nns.screen_ref(rows, N, q)
    err = (s_tilde - _plain(rows, N, q, None).double()).abs() / eps
    assert float(err.max()) < 0.25


def test_tf32_rounds_to_nearest_ties_away():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12, 1.0 + 3 * 2.0 ** -12, 0.0])
    assert nns._tf32(x).tolist() == [1.0, 1.0 + 2.0 ** -10,
                                     -(1.0 + 2.0 ** -10), 1.0,
                                     1.0 + 2.0 ** -10, 0.0]


def test_query_scale_is_summed_in_the_plain_order():
    """The scale the kernels' merge applies: ||q||^2 summed d = 0..D-1 in
    float32, one rounding per square and per sum."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((4, 48)).astype(np.float32)
    ss = np.zeros(4, np.float32)
    for d in range(48):
        ss = (ss + q[:, d] * q[:, d]).astype(np.float32)
    want = (np.float32(1.0) / np.maximum(np.sqrt(ss), np.float32(1e-12)))
    np.testing.assert_array_equal(nns._q_scale(torch.from_numpy(q)).numpy(),
                                  want)
    zero = torch.zeros((1, 8))
    assert nns._q_scale(zero).tolist() == [pytest.approx(1e12)]


def test_misaligned_pointers_raise_instead_of_copying():
    t = torch.zeros(64)
    nns._check_aligned("scan", bank=t[4:])
    with pytest.raises(ValueError, match="queries is not 16-byte aligned"):
        nns._check_aligned("scan", bank=t, queries=t[1:])
