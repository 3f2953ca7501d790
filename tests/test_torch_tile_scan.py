"""Parity of the tile scan K2 (``cslam_tpu_torch.ops.nns.cosine_topk_fused``)
with the TPU kernel itself, ``cslam_tpu.ops.nns_pallas.cosine_topk_fused``,
run as the JAX package's own tests run it on the CPU (``interpret=True``).

On the CPU the wrapper runs the kernel's plain version, which rounds as the
kernel does (the kernel is held against it bit for bit on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``). Against the JAX
package: indices and tie order exactly; similarities within 1e-5 relative /
1e-6 absolute, the float32 rounding of a different summation order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cslam_tpu.ops.nns_pallas import TILE_N
from cslam_tpu.ops.nns_pallas import cosine_topk_fused as jax_fused
from cslam_tpu_torch.ops import nns
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
N, D, B = 2 * TILE_N, 32, 6


def _bank(seed):
    rng = np.random.default_rng(seed)
    bank = (rng.standard_normal((N, D)) * rng.uniform(0.5, 2.0, (N, 1))
            ).astype(np.float32)
    inv = (1.0 / np.linalg.norm(bank, axis=1)).astype(np.float32)
    q = rng.standard_normal((B, D)).astype(np.float32)
    return bank, inv, q


def _check(bank, inv, n, q, k, bank_t=None):
    """Port wrapper (CPU: plain version) against the Pallas kernel in
    interpret mode on the same inputs."""
    bank_t = torch.from_numpy(bank) if bank_t is None else bank_t
    jbank = jnp.asarray(bank if bank_t.dtype == torch.float32
                        else bank_t.float().numpy()).astype(
        jnp.bfloat16 if bank_t.dtype == torch.bfloat16 else jnp.float32)
    jv, ji = jax_fused(jbank, jnp.asarray(inv), jnp.int32(n), jnp.asarray(q),
                       k, interpret=True)
    before = nns.tile_scan_launches
    tv, ti = nns.cosine_topk_fused(bank_t, torch.from_numpy(inv), n,
                                   torch.from_numpy(q), k)
    assert nns.tile_scan_launches == before   # CPU: the plain version
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL,
                               atol=ATOL)
    return tv, ti


def test_partial_last_tile():
    bank, inv, q = _bank(7)
    _check(bank, inv, N - TILE_N // 2 + 3, q, 10)


def test_duplicated_rows_across_tiles_tie_order():
    """Rows 7, 9 and TILE_N + 4 equal the query: ascending row index, across
    tiles too."""
    bank, inv, q = _bank(9)
    for r in (9, TILE_N + 4):
        bank[r], inv[r] = bank[7], inv[7]
    q[2] = bank[7]
    _, ti = _check(bank, inv, N, q, 10)
    assert list(ti[2, :3].numpy()) == [7, 9, TILE_N + 4]


def test_fewer_valid_rows_than_k_repeat_row_zero():
    """n = 5, k = 8: the five valid rows, then (-inf, 0) three times (the
    TPU kernel's argmax over an all -inf tile), not ``cosine_topk``'s
    5, 6, 7."""
    bank, inv, q = _bank(8)
    tv, ti = _check(bank, inv, 5, q, 8)
    assert np.isneginf(tv[:, 5:].numpy()).all()
    assert (ti[:, 5:].numpy() == 0).all()
    assert sorted(ti[0, :5].tolist()) == [0, 1, 2, 3, 4]


def test_bf16_bank_widened_queries_unrounded():
    """A bf16 bank is read as bf16 and widened to f32; queries stay f32."""
    bank, inv, q = _bank(21)
    bank_bf = torch.from_numpy(bank).to(torch.bfloat16)
    _check(bank, inv, N - 100, q, 10, bank_t=bank_bf)


@pytest.mark.parametrize("k", [0, nns.KERNEL_K + 1])
def test_k_outside_the_contract_raises(k):
    bank, inv, q = _bank(1)
    with pytest.raises(ValueError, match="1 <= k <= 10"):
        nns.cosine_topk_fused(torch.from_numpy(bank), torch.from_numpy(inv),
                              N, torch.from_numpy(q), k)
