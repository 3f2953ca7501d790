"""Parity of the bank scan K1 (``cslam_tpu_torch.ops.nns``) with the JAX
package, mirroring ``tests/test_sparse_matching.py``'s kernel cases: partial
tiles, ties from duplicated rows, tiny and partial counts, B > 512, random
k, and the bf16 bank.

On the CPU the wrapper runs the kernel's plain version, which sums the dot
products in the kernel's own order and roundings (the kernel itself is held
against it bit for bit on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``). Against the JAX package: indices and tie order exactly;
similarities within 1e-5 relative / 1e-6 absolute, the float32 rounding of
a different summation order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cslam_tpu.ops import topk as jtopk
from cslam_tpu_torch.ops import nns
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _check(bank, n, q, k):
    """Port wrapper (CPU: plain version) vs the JAX XLA top-k, unit rows."""
    jv, ji = jtopk.cosine_topk(jnp.asarray(bank),
                               jnp.ones(bank.shape[0], jnp.float32),
                               jnp.int32(n), jnp.asarray(q), k)
    tv, ti = nns.cosine_topk_scan(torch.from_numpy(bank), n,
                                  torch.from_numpy(q), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL,
                               atol=ATOL)
    return tv, ti


def test_partial_tile_agreement():
    rng = np.random.default_rng(7)
    bank = _unit(rng.standard_normal((8192, 32)))
    q = rng.standard_normal((8, 32)).astype(np.float32)
    _check(bank, 8192 - 2048, q, 10)


def test_duplicate_descriptors_tie_order():
    rng = np.random.default_rng(9)
    bank = _unit(rng.standard_normal((8192, 32)))
    bank[300] = bank[100]
    bank[4096 + 17] = bank[100]
    q = rng.standard_normal((6, 32)).astype(np.float32)
    q[2] = bank[100]
    _, ti = _check(bank, 8192, q, 10)
    assert list(ti[2, :3].numpy()) == [100, 300, 4113]


@pytest.mark.parametrize("n", [1, 5, 129, 4096])
def test_tiny_and_partial_counts(n):
    """n < k pads with (-inf, n, n+1, ...) exactly like lax.top_k over the
    masked bank."""
    rng = np.random.default_rng(10)
    bank = _unit(rng.standard_normal((4096, 16)))
    q = rng.standard_normal((4, 16)).astype(np.float32)
    tv, ti = _check(bank, n, q, 8)
    if n < 8:
        assert np.all(np.isneginf(tv[:, n:].numpy()))
        assert list(ti[0, n:].numpy()) == list(range(n, 8))


def test_batch_above_512():
    rng = np.random.default_rng(13)
    bank = _unit(rng.standard_normal((4096, 16)))
    q = rng.standard_normal((576, 16)).astype(np.float32)
    _check(bank, 4096 - 123, q, 5)


@pytest.mark.parametrize("trial", range(3))
def test_fuzz_random_counts(trial):
    rng = np.random.default_rng(100 + trial)
    bank = _unit(rng.standard_normal((2048, 24)))
    q = rng.standard_normal((5, 24)).astype(np.float32)
    _check(bank, int(rng.integers(1, 2049)), q, int(rng.integers(1, 12)))


def test_bf16_bank_exact_on_rounded_inputs():
    """bf16 bank: the exact top-k of the bf16-rounded inputs, scaled by the
    ORIGINAL f32 query norm (the JAX kernel's contract, compared the way
    ``test_kernel_exact_on_bf16_rounded_inputs`` does)."""
    rng = np.random.default_rng(21)
    bank = _unit(rng.standard_normal((8192, 32)))
    q = rng.standard_normal((6, 32)).astype(np.float32)
    n = 8192 - 100
    bank_bf = torch.from_numpy(bank).to(torch.bfloat16)
    tv, ti = nns.cosine_topk_scan(bank_bf, n, torch.from_numpy(q), 10)
    bank_rt = bank_bf.float().numpy()
    q_rt = torch.from_numpy(q).to(torch.bfloat16).float().numpy()
    rv, ri = jtopk.cosine_topk(jnp.asarray(bank_rt),
                               jnp.ones(8192, jnp.float32), jnp.int32(n),
                               jnp.asarray(q_rt), 10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    q_inv = 1.0 / np.linalg.norm(q, axis=1)
    q_rt_inv = 1.0 / np.linalg.norm(q_rt, axis=1)
    np.testing.assert_allclose(tv.numpy() / q_inv[:, None],
                               np.asarray(rv) / q_rt_inv[:, None],
                               rtol=1e-4, atol=1e-5)


def test_matches_pallas_kernel_in_interpret_mode():
    """Against the TPU kernel itself, run as the JAX package's own tests run
    it on the CPU (``interpret=True``)."""
    from cslam_tpu.ops.nns_pallas import TILE_N, cosine_topk_fused2_pre
    rng = np.random.default_rng(31)
    bank = _unit(rng.standard_normal((2 * TILE_N, 24)))
    q = rng.standard_normal((5, 24)).astype(np.float32)
    n = TILE_N + 700
    fv, fi = cosine_topk_fused2_pre(jnp.asarray(bank), jnp.int32(n),
                                    jnp.asarray(q), 10, interpret=True)
    tv, ti = nns.cosine_topk_scan(torch.from_numpy(bank), n,
                                  torch.from_numpy(q), 10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(fi))
    np.testing.assert_allclose(tv.numpy(), np.asarray(fv), rtol=RTOL,
                               atol=ATOL)


def test_descriptor_bank_matches_reference():
    """The port's DescriptorBank (CPU) against the JAX one on the same
    stream of appends: same items, same order, growth included."""
    from cslam_tpu.matching.nns_bank import DescriptorBank as JBank
    from cslam_tpu_torch.matching.nns_bank import DescriptorBank as TBank
    rng = np.random.default_rng(22)
    rows = rng.standard_normal((300, 32)).astype(np.float32)
    jb, tb = JBank(capacity=128), TBank(capacity=128, device="cpu")
    for i, r in enumerate(rows):
        jb.add_item(r, ("kf", i))
        tb.add_item(r, ("kf", i))
    q = rows[[5, 77, 299]] + 0.05 * rng.standard_normal((3, 32)).astype(
        np.float32)
    js, ji = jb.search_batch(q, 3)
    ts, ti = tb.search_batch(q, 3)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=RTOL, atol=ATOL)
    assert tb.capacity == jb.capacity == 512
    assert tb.search_best(q[1])[0] == jb.search_best(q[1])[0] == ("kf", 77)
