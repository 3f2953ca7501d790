"""Parity of the port's plain top-k ops (``cslam_tpu_torch.ops.topk``) with
``cslam_tpu.ops.topk`` on the same seeded inputs.

Tolerances: indices and tie order must match exactly; similarities agree
within 1e-5 relative / 1e-6 absolute, the float32 rounding of two different
matmul summation orders (XLA's vs PyTorch's) on unit-scale dot products.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cslam_tpu.ops import topk as jtopk
from cslam_tpu_torch.ops import topk as ttopk
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6


def _both(bank, inv, n, q, k):
    jv, ji = jtopk.cosine_topk(jnp.asarray(bank), jnp.asarray(inv),
                               jnp.int32(n), jnp.asarray(q), k)
    tv, ti = ttopk.cosine_topk(torch.from_numpy(bank), torch.from_numpy(inv),
                               n, torch.from_numpy(q), k)
    return (np.asarray(jv), np.asarray(ji)), (tv.numpy(), ti.numpy())


@pytest.mark.parametrize("n,k", [(700, 10), (5, 8), (1, 4), (1024, 1)])
def test_cosine_topk_matches_reference(n, k):
    rng = np.random.default_rng(n)
    bank = rng.standard_normal((1024, 24)).astype(np.float32)
    inv = (1.0 / np.linalg.norm(bank, axis=1)).astype(np.float32)
    q = rng.standard_normal((7, 24)).astype(np.float32)
    (jv, ji), (tv, ti) = _both(bank, inv, n, q, k)
    np.testing.assert_array_equal(ji, ti)
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL)


def test_tie_order_ascending_index():
    """Duplicated rows tie exactly; ``lax.top_k`` orders them by ascending
    index and the port must too (``torch.topk`` promises no order)."""
    rng = np.random.default_rng(9)
    bank = rng.standard_normal((512, 16)).astype(np.float32)
    for r in (300, 17, 411):
        bank[r] = bank[100]
    inv = np.ones(512, np.float32)
    q = rng.standard_normal((4, 16)).astype(np.float32)
    q[2] = bank[100]
    (jv, ji), (tv, ti) = _both(bank, inv, 512, q, 10)
    np.testing.assert_array_equal(ji, ti)
    assert list(ti[2, :4]) == [17, 100, 300, 411]


def test_update_rows_unit_matches_reference():
    rng = np.random.default_rng(3)
    rows = rng.standard_normal((6, 16)).astype(np.float32)
    jb = jtopk.update_rows_unit(jnp.zeros((16, 16), jnp.float32),
                                jnp.asarray(rows), jnp.int32(4))
    tb = ttopk.update_rows_unit(torch.zeros((16, 16)), torch.from_numpy(rows),
                                4)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6,
                               atol=1e-7)
    jb2, jinv = jtopk.update_rows(jnp.zeros((16, 16), jnp.float32),
                                  jnp.ones(16, jnp.float32),
                                  jnp.asarray(rows), jnp.int32(2))
    tb2, tinv = ttopk.update_rows(torch.zeros((16, 16)), torch.ones(16),
                                  torch.from_numpy(rows), 2)
    np.testing.assert_array_equal(tb2.numpy(), np.asarray(jb2))
    np.testing.assert_allclose(tinv.numpy(), np.asarray(jinv), rtol=1e-6)


def test_cosine_top1_multi_matches_reference():
    rng = np.random.default_rng(5)
    banks = rng.standard_normal((3, 64, 12)).astype(np.float32)
    banks[1, 40] = banks[1, 7]        # a tie: argmax takes the first index
    inv = (1.0 / np.linalg.norm(banks, axis=2)).astype(np.float32)
    ns = np.array([64, 50, 0], np.int32)
    q = banks[1, 7].copy()
    js, ji = jtopk.cosine_top1_multi(jnp.asarray(banks), jnp.asarray(inv),
                                     jnp.asarray(ns), jnp.asarray(q))
    ts, ti = ttopk.cosine_top1_multi(torch.from_numpy(banks),
                                     torch.from_numpy(inv),
                                     torch.from_numpy(ns), torch.from_numpy(q))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL,
                               atol=ATOL)
    assert int(ti[1]) == 7 and np.isneginf(ts[2].item())
