"""The port's Scan Context path against the JAX package, on the CPU: binning,
ring keys and distances, the model, the bank's two-stage search (unfused,
fused through K1's plain version, multi-bank), the lidar branch of sparse
matching. Both packages get the same seeded numpy inputs.

Tolerances: binning bit for bit (same float32 arithmetic, same bins);
distances within 1e-6 (the port sums the ring contraction in another
order); best rows exact.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cslam_tpu.matching import scancontext_bank as jbank
from cslam_tpu.matching.sparse_matching import \
    LoopClosureSparseMatching as JLCSM
from cslam_tpu.models import make_global_descriptor as j_model
from cslam_tpu.ops import scancontext as jsc
from cslam_tpu.ops import topk as jtopk
from cslam_tpu.ops.nns_pallas import TILE_N
from cslam_tpu_torch.matching import scancontext_bank as tbank
from cslam_tpu_torch.matching.sparse_matching import \
    LoopClosureSparseMatching as TLCSM
from cslam_tpu_torch.models import make_global_descriptor as t_model
from cslam_tpu_torch.ops import nns
from cslam_tpu_torch.ops import scancontext as tsc
from cslam_tpu_torch.ops import topk as ttopk
from helpers import matching_params
from torch_threads import one_torch_thread  # noqa: F401

DIST_TOL = 1e-6


def random_cloud(rng, n=800, radius=90.0):
    """Polar-uniform points out past the 80 m rim, with NaN rows."""
    r = rng.uniform(0, radius, n)
    theta = rng.uniform(0, 2 * np.pi, n)
    z = rng.uniform(-3.0, 4.0, n)
    pts = np.stack([r * np.cos(theta), r * np.sin(theta), z], 1)
    pts[::37] = np.nan
    return pts.astype(np.float32)


def scans(rng, count):
    """Sparse scan-context-like descriptors (zero columns included)."""
    return [(rng.random((20, 60)) * (rng.random((20, 60)) > 0.6)
             * 6.0).astype(np.float32) for _ in range(count)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_binning_bit_for_bit(seed):
    pts = random_cloud(np.random.default_rng(seed))
    want = np.asarray(jsc.points_to_scancontext(jnp.asarray(pts)))
    got = tsc.points_to_scancontext(torch.from_numpy(pts)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(tsc.points_to_scancontext_np(pts), want)


def test_ring_key_and_distances():
    rng = np.random.default_rng(3)
    cands = np.stack(scans(rng, 9))
    query = np.roll(cands[4], 17, axis=1) + 0.05 * rng.random(
        (20, 60)).astype(np.float32)
    cands[2] = 0.0                                  # no engaged column
    np.testing.assert_allclose(
        tsc.ring_key(torch.from_numpy(cands)).numpy(),
        np.asarray(jax.vmap(jsc.ring_key)(jnp.asarray(cands))), atol=1e-6)
    jd, jy = jsc.scancontext_distances_batch(jnp.asarray(cands),
                                             jnp.asarray(query))
    td, ty = tsc.scancontext_distances_batch(torch.from_numpy(cands),
                                             torch.from_numpy(query))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=DIST_TOL)
    assert np.array_equal(ty.numpy(), np.asarray(jy))
    d1, y1 = tsc.scancontext_distance(torch.from_numpy(cands[4]),
                                      torch.from_numpy(query))
    jd1, jy1 = jsc.scancontext_distance(jnp.asarray(cands[4]),
                                        jnp.asarray(query))
    assert abs(float(d1) - float(jd1)) <= DIST_TOL and int(y1) == int(jy1)


@pytest.mark.parametrize("host_binning", [True, False])
def test_model_matches_reference(host_binning):
    params = {"frontend.global_descriptor_technique": "scancontext",
              "frontend.scancontext_host_binning": host_binning}
    pts = random_cloud(np.random.default_rng(4), n=1500)
    got = t_model(params, device="cpu").compute_embedding(pts)
    want = j_model(params).compute_embedding(pts)
    assert got.shape == (1200,) and np.array_equal(got, want)


def _filled(bank_cls, descs, capacity=8, **kwargs):
    bank = bank_cls(capacity=capacity, **kwargs)
    for i, d in enumerate(descs):
        bank.add_item(d.reshape(-1), ("kf", i))
    return bank


def _probes(rng, descs):
    return np.stack([descs[3], np.roll(descs[11], 29, axis=1),
                     descs[20] + 0.1, rng.random((20, 60)).astype(
                         np.float32)]).reshape(4, -1)


def test_bank_search_best_and_batch_match_reference():
    rng = np.random.default_rng(5)
    descs = scans(rng, 25)
    jb = _filled(jbank.ScanContextBank, descs)
    tb = _filled(tbank.ScanContextBank, descs, device="cpu")
    probes = _probes(rng, descs)
    want = jb.search_best_batch(probes)
    got = tb.search_best_batch(probes)
    assert [g[0] for g in got] == [w[0] for w in want]
    np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want],
                               atol=DIST_TOL)
    assert got[0][0] == ("kf", 3) and got[1][0] == ("kf", 11)
    for p in probes:
        item, sim = tb.search_best(p)
        ref_item, ref_sim = jb.search_best(p)
        assert item == ref_item and abs(sim - ref_sim) <= DIST_TOL
    # rows added after a search are synced before the next one
    tb.add_item(descs[0].reshape(-1) * 0.5, "late")
    jb.add_item(descs[0].reshape(-1) * 0.5, "late")
    q = descs[0] * 0.5
    assert tb.search_best(q)[0] == jb.search_best(q)[0] == "late"
    assert tbank.ScanContextBank(device="cpu").search_best(
        np.zeros(1200)) == (None, None)


def test_multi_bank_search_matches_reference():
    rng = np.random.default_rng(6)
    counts = (5, 8, 11)
    tbanks, jbanks = [], []
    for r, c in enumerate(counts):
        descs = scans(rng, c)
        # capacity >= 32: the JAX package's multi-bank append pads to
        # 32-row blocks and fails on smaller banks
        tbanks.append(_filled(tbank.ScanContextBank, descs, 32,
                              device="cpu"))
        jbanks.append(_filled(jbank.ScanContextBank, descs, 32))
    tbanks.append(tbank.ScanContextBank(device="cpu"))   # empty bank
    jbanks.append(jbank.ScanContextBank())
    for query in (tbanks[1]._sc_host[2], tbanks[2]._sc_host[7] + 0.2):
        got = tbank.multi_search_best(tbanks, query)
        want = jbank.multi_search_best(jbanks, query)
        assert [g[0] for g in got] == [w[0] for w in want]
        np.testing.assert_allclose([g[1] or 0.0 for g in got],
                                   [w[1] or 0.0 for w in want],
                                   atol=DIST_TOL)
        assert got == [b.search_best(query) for b in tbanks]
    assert got[3] == (None, None)


def test_packed_index_bound_is_asserted():
    """The packed [2R] float32 result holds row indices exactly only up to
    2^24 rows; a larger bank raises instead of returning a rounded row."""
    rk = torch.zeros((4, 20))
    sc = torch.zeros((4, 20, 60))
    q = torch.zeros((20, 60))
    with pytest.raises(ValueError, match="packed float32"):
        tbank._multi_bank_best([rk], [rk[:, 0]], [sc],
                               [tbank.MAX_PACKED_ROWS + 1], q, 10)
    packed = tbank._multi_bank_best([rk], [rk[:, 0]], [sc], [3], q, 10)
    assert packed.shape == (2,) and packed.dtype == torch.float32


@pytest.fixture(scope="module")
def fused_case():
    """A 4096-row bank (one TILE_N), 4 near-duplicate queries."""
    rng = np.random.default_rng(22)
    N, B = TILE_N, 4
    sc_bank = rng.uniform(0, 5, (N, 20, 60)).astype(np.float32)
    queries = (sc_bank[rng.integers(0, 200, B)]
               + rng.normal(0, 0.05, (B, 20, 60)).astype(np.float32))
    rk = sc_bank.mean(-1)
    return sc_bank, queries, rk, N - 11


def test_augmented_k1_orders_like_euclidean(fused_case):
    """K1's plain version over the augmented rows returns the euclidean
    shortlist of both packages' ``euclidean_topk``, index for index."""
    _, queries, rk, n = fused_case
    rk_q = queries.mean(-1)
    want = jtopk.euclidean_topk(jnp.asarray(rk), jnp.sum(
        jnp.asarray(rk) ** 2, -1), jnp.int32(n), jnp.asarray(rk_q), 10)[1]
    rk_t = torch.from_numpy(rk)
    _, got = ttopk.euclidean_topk(rk_t, (rk_t * rk_t).sum(-1), n,
                                  torch.from_numpy(rk_q), 10)
    aug = tbank._augment_ring_keys(rk_t)
    q_aug = tbank._augment_queries(torch.from_numpy(rk_q))
    assert aug.shape == (len(rk), 32) and q_aug.is_contiguous()
    _, k1 = nns.cosine_topk_scan(aug, n, q_aug, 10)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(k1.numpy(), np.asarray(want))


def test_fused_stage1_matches_reference_and_unfused(fused_case):
    """The port's fused two-stage search (K1's plain version on the CPU)
    against the JAX fused search (Pallas K1 in interpret mode) and both
    unfused searches: the same best rows."""
    sc_bank, queries, rk, n = fused_case
    j_idx, j_d = jbank._two_stage_best_fused(
        jbank._augment_ring_keys(jnp.asarray(rk)), jnp.asarray(sc_bank),
        jnp.int32(n), jnp.asarray(queries), 10, interpret=True)
    ju_idx, _ = jbank._two_stage_best(
        jnp.asarray(rk), jnp.sum(jnp.asarray(rk) ** 2, -1),
        jnp.asarray(sc_bank), jnp.int32(n), jnp.asarray(queries), 10)
    rk_t, sc_t = torch.from_numpy(rk), torch.from_numpy(sc_bank)
    q_t = torch.from_numpy(queries)
    before = nns.launches
    f_idx, f_d = tbank._two_stage_best_fused(
        tbank._augment_ring_keys(rk_t), sc_t, n, q_t, 10)
    assert nns.launches == before           # the CPU takes the plain version
    u_idx, u_d = tbank._two_stage_best(rk_t, (rk_t * rk_t).sum(-1), sc_t, n,
                                       q_t, 10)
    for idx in (f_idx, u_idx):
        assert np.array_equal(idx.numpy(), np.asarray(j_idx))
    assert np.array_equal(np.asarray(ju_idx), np.asarray(j_idx))
    np.testing.assert_allclose(f_d.numpy(), np.asarray(j_d), atol=DIST_TOL)
    assert torch.equal(f_d, u_d)


def test_fused_stage1_gate():
    """The JAX package's gate with "TPU" read as "CUDA": opt-in, bank on
    the card, capacity a multiple of 4096, at most 10 candidates. (The
    banks allocate nothing on their device until a search.)"""
    def ok(**kw):
        args = {"capacity": 4096, "fused_stage1": True, "device": "cuda",
                **kw}
        return tbank.ScanContextBank(**args)._fused_stage1_ok()
    assert ok()
    assert ok(capacity=65536)
    assert not ok(fused_stage1=False)
    assert not ok(device="cpu")
    assert not ok(capacity=1024)
    assert not ok(num_candidates=11)
    assert not jbank.ScanContextBank(capacity=4096)._fused_stage1_ok()


class _GD:
    def __init__(self, kf, rid, d):
        self.keyframe_id, self.robot_id, self.descriptor = kf, rid, d


def test_lidar_sparse_matching_matches_reference():
    """The lidar branch of sparse matching: local keyframes searched in
    every other robot's bank (multi-bank search) and a gossip chunk in the
    local bank (batched search) give the reference's matches."""
    params = matching_params(max_nb_robots=3, sensor_type="lidar",
                             similarity_threshold=0.5)
    port, ref = TLCSM(params, device="cpu"), JLCSM(params)
    assert isinstance(port.local_nnsm, tbank.ScanContextBank)
    rng = np.random.default_rng(9)
    descs = [tsc.points_to_scancontext_np(random_cloud(rng, 600))
             for _ in range(12)]
    chunk = [_GD(k, 1 + k % 2, np.roll(descs[k], 7 * k, axis=1).reshape(-1))
             for k in range(6)]

    def keys(matches):
        return sorted((m.robot0_id, m.robot0_keyframe_id, m.robot1_id,
                       m.robot1_keyframe_id, round(m.weight, 5))
                      for m in matches)

    got = port.add_other_robot_global_descriptors(chunk[:2])
    want = ref.add_other_robot_global_descriptors(chunk[:2])
    assert keys(got) == keys(want) == []
    for i, d in enumerate(descs):
        got = port.add_local_global_descriptor(d.reshape(-1), i)
        want = ref.add_local_global_descriptor(d.reshape(-1), i)
        assert keys(got) == keys(want)
    got = port.add_other_robot_global_descriptors(chunk[2:])
    want = ref.add_other_robot_global_descriptors(chunk[2:])
    assert keys(got) == keys(want) and len(got) == 4
    assert keys(got)[0][1] == 2 and keys(got)[0][3] == 2
