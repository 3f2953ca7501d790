"""The port's lidar registration against the JAX package, on the CPU.

Both packages get the same seeded clouds (the JAX package's own test
scenes, ``tests/test_registration.py``), padded to 256 points except one
global-registration case at 1024. Tolerances: voxel downsampling, padding,
kNN indices and spectral selections exact; the closed-form smallest
eigenvector within 1e-5; the yaw correlation's chosen shift equal (its
translation within 1e-3 m of float32 rounding) on the yaws whose
correlation maximum is unique (the FFT's rounding decides
exact ties differently in the two packages); verified transforms within
1e-3 rad and 1e-2 m, success flags equal.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_registration as ref_tests
from cslam_tpu.ops import registration as J
from cslam_tpu.utils import profiling as j_profiling
from cslam_tpu_torch.ops import registration as T
from cslam_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401

ROT_TOL, TRANS_TOL = 1e-3, 1e-2
PAD = 256
VOXEL = 0.3
CORR = np.float32(VOXEL * 1.5)


def _known_pairs(rng, n=300):
    """Three revisits with known yaw and offset, one unrelated pair."""
    pairs = []
    for yaw, t in [(0, [0.5, -0.3, 0.1]), (95, [2.0, 1.0, 0.0]),
                   (180, [-1.0, 3.0, 0.2])]:
        src = ref_tests.structured_cloud(rng, n)
        dst = (ref_tests.transform_cloud(src, yaw, t)
               + rng.normal(scale=0.02, size=src.shape))
        pairs.append((src.astype(np.float32), dst.astype(np.float32)))
    src = ref_tests.structured_cloud(rng, n)[:150]
    dst = (rng.uniform(300, 400, (150, 3)) * [1, 1, 0.05]).astype(np.float32)
    pairs.append((src, dst))
    return pairs


def _padded(pairs, pad=PAD):
    cols = [np.stack([J.pad_cloud(p[i], pad)[j] for p in pairs])
            for i, j in ((0, 0), (0, 1), (1, 0), (1, 1))]
    return cols, [torch.from_numpy(c) for c in cols]


@pytest.fixture(scope="module")
def known():
    pairs = _known_pairs(np.random.default_rng(1))
    np_arrays, t_arrays = _padded(pairs)
    return pairs, np_arrays, t_arrays


def _assert_close_T(got, want):
    """Rotation angle between the two within ROT_TOL, translations within
    TRANS_TOL."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    dR = got[:3, :3].T @ want[:3, :3]
    angle = math.acos(min(1.0, max(-1.0, (np.trace(dR) - 1.0) / 2.0)))
    assert angle <= ROT_TOL, angle
    assert np.abs(got[:3, 3] - want[:3, 3]).max() <= TRANS_TOL


@pytest.mark.parametrize("voxel", [0.3, 1.0])
def test_voxel_downsample_and_pad_cloud_exact(voxel):
    rng = np.random.default_rng(0)
    pts = rng.uniform(-10, 10, (3000, 3))
    pts[::97] = np.nan
    down = T.voxel_downsample(pts, voxel)
    assert np.array_equal(down, J.voxel_downsample(pts, voxel))
    for size in (64, len(down), 4096):
        for a, b in zip(T.pad_cloud(down, size), J.pad_cloud(down, size)):
            assert np.array_equal(a, b)
    assert len(T.voxel_downsample(np.zeros((0, 3)), voxel)) == 0


def test_smallest_eigvec3_matches_reference():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((512, 16, 3)).astype(np.float32)
    X[:, :, 2] *= 0.3
    C = X - X.mean(1, keepdims=True)
    cov = (np.einsum("nki,nkj->nij", C, C)
           + 1e-9 * np.eye(3, dtype=np.float32))
    iso = np.tile(np.eye(3, dtype=np.float32)[None], (2, 1, 1))
    cov = np.concatenate([cov, iso]).astype(np.float32)
    got = T._smallest_eigvec3(torch.from_numpy(cov)).numpy()
    want = np.asarray(J._smallest_eigvec3(jnp.asarray(cov)))
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("kind", ["random", "rank2", "reflection", "zero"])
def test_closed_form_kabsch_rotation_matches_svd(kind):
    """``_rotation_from_cross_covariance`` against the JAX package's SVD
    form, ``V diag(1, 1, sign det(V U^T)) U^T`` of ``H = U S V^T``."""
    rng = np.random.default_rng(3)
    H = rng.standard_normal((64, 3, 3))
    if kind == "rank2":
        H = H @ np.diag([1.0, 1.0, 0.0]) @ rng.standard_normal((64, 3, 3))
    elif kind == "reflection":
        H = H * np.sign(np.linalg.det(H))[:, None, None] * -1.0
    elif kind == "zero":
        H = np.zeros((2, 3, 3))
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(np.swapaxes(Vt, 1, 2) @ np.swapaxes(U, 1, 2)))
    if kind == "zero":
        want = np.tile(np.eye(3), (2, 1, 1))
    else:
        D = np.zeros((len(H), 3, 3))
        D[:, 0, 0] = D[:, 1, 1] = 1.0
        D[:, 2, 2] = d
        want = np.swapaxes(Vt, 1, 2) @ D @ np.swapaxes(U, 1, 2)
    got = T._rotation_from_cross_covariance(torch.from_numpy(H)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-8)


def test_knn_indices_exact(known):
    (S, SM, _, _), (s, sm, _, _) = known[1], known[2]
    want_i, want_d = jax.vmap(lambda p, m: J._knn(p, m, 16))(
        jnp.asarray(S), jnp.asarray(SM))
    got_i, got_d = T._knn(s, sm, 16)
    assert np.array_equal(got_i.numpy(), np.asarray(want_i))
    fin = np.isfinite(np.asarray(want_d))
    assert np.array_equal(np.isfinite(got_d.numpy()), fin)
    np.testing.assert_allclose(got_d.numpy()[fin], np.asarray(want_d)[fin],
                               rtol=1e-5, atol=1e-5)


def test_spectral_inliers_selection_exact():
    rng = np.random.default_rng(5)
    p = rng.uniform(-10, 10, (2, 200, 3)).astype(np.float32)
    R = T._yaw_matrix(torch.tensor([0.3, 2.0])).numpy()
    q = p @ np.swapaxes(R, 1, 2) + np.float32(1.5)
    q[:, 120:] = rng.uniform(-10, 10, (2, 80, 3))     # outliers
    cand = (rng.random((2, 200)) > 0.1).astype(np.float32)
    want = jax.vmap(lambda a, b, c: J._spectral_inliers(
        a, b, c, CORR * 0.5, CORR * 2.0))(jnp.asarray(p), jnp.asarray(q),
                                           jnp.asarray(cand))
    got = T._spectral_inliers(torch.from_numpy(p), torch.from_numpy(q),
                              torch.from_numpy(cand),
                              torch.tensor(CORR) * 0.5,
                              torch.tensor(CORR) * 2.0)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert got[:, :120].sum() > 100 and got[:, 120:].sum() < 10


def _unique_max_yaws(s, sm, d, dm, n_yaw=32):
    """[P, Y] True where the yaw's correlation surface (recomputed exactly,
    float64 and rounded to the integer counts) has one maximum."""
    cs, cd = T._centroid(s, sm), T._centroid(d, dm)

    def ext(p, m, c):
        return ((p[..., :2] - c[:, None, :2]).abs()
                * m[..., None]).amax(dim=(-2, -1))
    half = torch.maximum(ext(s, sm, cs), ext(d, dm, cd)) * 1.05 + 1e-3
    cell = 2.0 * half / 64
    Hd = T._occupancy2d(d - cd[:, None], dm, cell, half).double().numpy()
    yaws = torch.arange(n_yaw, dtype=torch.float32) * (2 * math.pi / n_yaw)
    moved = (s - cs[:, None])[:, None] @ T._yaw_matrix(yaws).mT
    Hs = T._occupancy2d(moved, sm[:, None], cell[:, None],
                        half[:, None]).double().numpy()
    c = np.rint(np.fft.irfft2(np.fft.rfft2(Hd, s=(128, 128))[:, None]
                              * np.conj(np.fft.rfft2(Hs, s=(128, 128))),
                              s=(128, 128)))
    c[..., 64, :] = -1
    c[..., :, 64] = -1
    flat = c.reshape(c.shape[0], c.shape[1], -1)
    return (flat == flat.max(-1, keepdims=True)).sum(-1) == 1


def test_yaw_correlation_shift_on_tie_free_yaws(known):
    (S, SM, D, DM), (s, sm, d, dm) = known[1], known[2]
    _, tj, sj = jax.vmap(lambda *a: J._yaw_correlation_candidates(*a, 32))(
        jnp.asarray(S), jnp.asarray(SM), jnp.asarray(D), jnp.asarray(DM))
    _, tt, st = T._yaw_correlation_candidates(s, sm, d, dm, 32)
    unique = _unique_max_yaws(s, sm, d, dm)
    assert unique.sum() >= 32                     # enough to compare
    # t = cd - R cs + shift * cell: the same shift leaves only float32
    # rounding (the cell is 0.5 m here; another shift is a whole cell off)
    diff = np.abs(np.asarray(tj) - tt.numpy()).max(-1)
    assert diff[unique].max() <= 1e-3
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-2)


def test_robust_registration_matches_reference(known):
    (S, SM, D, DM), (s, sm, d, dm) = known[1], known[2]
    got_T, got_inl = T.robust_registration_batch(s, sm, d, dm,
                                                 torch.tensor(CORR))
    for i in range(3):               # the revisits; the unrelated pair fails
        want_T, want_inl = J.robust_registration(
            jnp.asarray(S[i]), jnp.asarray(SM[i]), jnp.asarray(D[i]),
            jnp.asarray(DM[i]), corr_dist=float(CORR))
        _assert_close_T(got_T[i].numpy(), want_T)
        assert abs(float(got_inl[i]) - float(want_inl)) <= 2.0
        assert float(got_inl[i]) > 0.9 * PAD


@pytest.mark.parametrize("name", ["robust_registration",
                                  "global_registration"])
def test_single_pair_and_batch_names_match_reference(known, name):
    """The JAX package's surface: ``name`` takes one pair ``[N, 3]`` (a
    float ``corr_dist``), ``name + '_batch'`` takes ``[P, N, 3]``; both
    packages get the same inputs. Same limits as above."""
    (S, SM, D, DM), (s, sm, d, dm) = known[1], known[2]
    one, batch = getattr(T, name), getattr(T, name + "_batch")
    j_one, j_batch = getattr(J, name), getattr(J, name + "_batch")
    got_T, got_inl = one(s[0], sm[0], d[0], dm[0], float(CORR))
    assert got_T.shape == (4, 4) and got_inl.dim() == 0
    want_T, want_inl = j_one(jnp.asarray(S[0]), jnp.asarray(SM[0]),
                             jnp.asarray(D[0]), jnp.asarray(DM[0]),
                             corr_dist=float(CORR))
    _assert_close_T(got_T.numpy(), want_T)
    assert abs(float(got_inl) - float(want_inl)) <= 2.0
    got_Tb, got_inlb = batch(s[:2], sm[:2], d[:2], dm[:2], float(CORR))
    want_Tb, want_inlb = j_batch(jnp.asarray(S[:2]), jnp.asarray(SM[:2]),
                                 jnp.asarray(D[:2]), jnp.asarray(DM[:2]),
                                 float(CORR))
    assert got_Tb.shape == (2, 4, 4) and got_inlb.shape == (2,)
    for i in range(2):
        _assert_close_T(got_Tb[i].numpy(), np.asarray(want_Tb)[i])
        assert abs(float(got_inlb[i]) - float(want_inlb[i])) <= 2.0
    # the single-pair call is the batch's first row
    torch.testing.assert_close(got_T, got_Tb[0], rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def verify_results(known):
    (S, SM, D, DM), (s, sm, d, dm) = known[1], known[2]
    want = J._verify_pair_batch(S, SM, D, DM, CORR, np.float32(60),
                                np.float32(0.6))
    got = T._verify_pair_batch(s, sm, d, dm, torch.tensor(CORR), 60.0,
                               float(np.float32(0.6)))
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def test_verify_pair_batch_flags_match_reference(verify_results):
    want, got = verify_results
    assert np.array_equal(got[2], want[2])             # success
    assert np.array_equal(got[3], want[3])             # ICP gate
    assert got[2].tolist() == [True, True, True, False]


def test_verify_pair_batch_transforms_match_reference(verify_results):
    want, got = verify_results
    for i in np.nonzero(want[2])[0]:
        _assert_close_T(got[0][i], want[0][i])
        assert abs(got[1][i] - want[1][i]) <= 2.0


def test_compute_transform_matches_reference(known):
    pairs = known[0]
    got = T.compute_transform_batch(pairs, VOXEL, 60, pad_size=PAD,
                                    device="cpu")
    for (src, dst), (Zb, okb) in zip(pairs, got):
        Z, ok = T.compute_transform(src, dst, VOXEL, 60, pad_size=PAD,
                                    device="cpu")
        Zr, okr = J.compute_transform(src, dst, VOXEL, 60, pad_size=PAD)
        assert ok == okr == okb
        if ok:
            _assert_close_T(Z, Zr)
            _assert_close_T(Zb, Zr)


def test_compute_transform_batch_counts_icp_gate(known):
    profiling.reset_spans()
    got = T.compute_transform_batch(known[0], VOXEL, 60, pad_size=PAD,
                                    max_pair_tier=3, device="cpu")
    counts = profiling.counters()
    assert len(got) == 4 and counts["verify.pairs"] == 4
    assert counts["verify.icp_gate_pass"] == 3
    assert T.compute_transform_batch([], VOXEL, 60, device="cpu") == []
    profiling.reset_spans()
    j_profiling.reset_spans()


@pytest.fixture(scope="module")
def padded_chunks(known):
    """``compute_transform_batch_begin`` of chunks that are not a power of
    two, in both packages: 3 pairs at cap 2 (chunks of 2 and 1) and 5 at
    cap 8 (one chunk of 5, padded to the tier of 8 by repeating its last
    pair). Returns per case (port handles, JAX handles, ``verify.pairs``)."""
    pairs = known[0]
    out = {}
    for name, chunk, cap in (("3_at_cap_2", pairs[:3], 2),
                             ("5_at_cap_8", pairs + pairs[:1], 8)):
        profiling.reset_spans()
        got = T.compute_transform_batch_begin(chunk, VOXEL, 60, pad_size=PAD,
                                              max_pair_tier=cap, device="cpu")
        for h in got:
            T.compute_transform_batch_step(h)
        counted = profiling.counters()["verify.pairs"]
        want = J.compute_transform_batch_begin(chunk, VOXEL, 60, pad_size=PAD,
                                               max_pair_tier=cap)
        for h in want:
            J.compute_transform_batch_step(h)
        out[name] = (got, want, counted)
    profiling.reset_spans()
    j_profiling.reset_spans()
    return out


@pytest.mark.parametrize("case", ["3_at_cap_2", "5_at_cap_8"])
def test_padded_chunks_match_reference(padded_chunks, case):
    """Chunks padded to the JAX package's tiers: the same tier and live
    count per chunk, the live pairs' flags equal, the verified pairs'
    transforms and inlier counts within this file's limits; ``verify.pairs``
    counts live pairs only."""
    got, want, counted = padded_chunks[case]
    assert [(h.p, h.T_dev.shape[0]) for h in got] == [
        (h.p, np.asarray(h.T_dev).shape[0]) for h in want]
    assert counted == sum(h.p for h in got) == int(case[0])
    for hg, hw in zip(got, want):
        assert len(hg.results) == hg.p
        inl_w = np.asarray(hw.inl_dev)
        for i, ((Zg, okg), (Zw, okw)) in enumerate(zip(hg.results,
                                                       hw.results)):
            assert okg == okw
            if okw:
                _assert_close_T(Zg, Zw)
                assert abs(float(hg.inl_dev[i]) - float(inl_w[i])) <= 2.0


@pytest.fixture(scope="module")
def large_offset():
    """The JAX package's prior-free case at pad 1024: a 40 m block seen
    from two viewpoints 6.7 m apart at yaws 20 and 137 degrees."""
    rng = np.random.default_rng(11)
    world = ref_tests.TestGlobalRegistration._world(rng)
    view = ref_tests.TestGlobalRegistration._view
    src = view(world, np.zeros(3), 20.0, 17.0, rng)
    dst = view(world, np.array([6.0, 3.0, 0.0]), 137.0, 17.0, rng)
    return _padded([(src, dst)], 1024)


def test_global_registration_matches_reference_at_1024(large_offset):
    (S, SM, D, DM), (s, sm, d, dm) = large_offset
    corr = np.float32(0.4 * 1.5)
    want_T, want_inl = J.global_registration(
        jnp.asarray(S[0]), jnp.asarray(SM[0]), jnp.asarray(D[0]),
        jnp.asarray(DM[0]), corr_dist=float(corr))
    got_T, got_inl = T.global_registration_batch(s, sm, d, dm,
                                                 torch.tensor(corr))
    _assert_close_T(got_T[0].numpy(), want_T)
    assert abs(float(got_inl[0]) - float(want_inl)) <= 2.0
    n_src = float(SM[0].sum())
    # the inlier gate the test scene is built to pass (ratio 0.45)
    assert float(got_inl[0]) > 60 and float(got_inl[0]) / n_src > 0.45
