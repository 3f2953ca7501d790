"""Tests that need the CUDA device: the hand-written kernels (K1, the bank
scan, also on the scan-context bank's augmented ring keys, and K2, the tile
scan) against their plain PyTorch versions, and the large-graph solver
tiers (MAC's Woodbury/LOBPCG tier, PGO's PCG tier), one lidar
verification chunk and one visual 3D-3D and one projective verification
chunk on the card (replayed CUDA graphs) against the same on the CPU, the
graph cache itself (``utils.tier_graphs``), and the PGO solver's LM and
PCG step programs replayed from their graphs against the same programs
launched eagerly. They skip on a machine without a GPU.

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


def _slam_mac_inputs(seed=3, robots=3, poses=200, loops=12, nb_cands=60):
    """Three 200-pose odometry chains (a P = 1024 tier), verified loops
    between them, and candidates with distinct weights."""
    from cslam_tpu_torch.types import Edge
    rng = np.random.default_rng(seed)
    n = robots * poses
    fixed = [Edge(r * poses + k, r * poses + k + 1, 1.0)
             for r in range(robots) for k in range(poses - 1)]
    for _ in range(loops):
        r = int(rng.integers(0, robots - 1))
        fixed.append(Edge(r * poses + int(rng.integers(0, poses)),
                          (r + 1) * poses + int(rng.integers(0, poses)),
                          float(rng.uniform(0.5, 1.0))))
    cands, seen = [], set()
    while len(cands) < nb_cands:
        i, j = (int(x) for x in rng.integers(0, n, 2))
        if abs(i - j) > 1 and (i, j) not in seen:
            seen.add((i, j))
            cands.append(Edge(i, j, float(rng.uniform(0.1, 1.0))))
    return n, fixed, cands


@pytest.mark.cuda
def test_woodbury_mac_on_card_matches_cpu():
    """The chain + low-rank MAC tier (P = 1024, config-default kwargs: warm
    Ritz block, best rounding) on the card selects what it selects on the
    CPU; lambda_2 within 1e-3 relative (float32 LOBPCG, cuBLAS/cuSOLVER
    against LAPACK)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cslam_tpu_torch.selection.mac import MAC, mac_kwargs_from_params
    n, fixed, cands = _slam_mac_inputs()
    kw = mac_kwargs_from_params({})
    w0 = np.zeros(len(cands))
    w0[:5] = 1.0
    out = {}
    for device in ("cuda", "cpu"):
        mac = MAC(fixed, cands, n, device=device, **kw)
        assert not mac._dense and mac._P == 1024
        sel, _, dual = mac.fw_subset(w0, 5, max_iters=20)
        out[device] = (sel, mac.evaluate_objective(sel), dual)
    np.testing.assert_array_equal(out["cuda"][0], out["cpu"][0])
    assert out["cuda"][1] == pytest.approx(out["cpu"][1], rel=1e-3)
    assert out["cuda"][2] == pytest.approx(out["cpu"][2], rel=1e-3)


@pytest.mark.cuda
def test_pcg_lm_optimize_on_card_matches_cpu():
    """LM on the PCG tier (two 288-pose robots, a 1024-node tier, the
    graph ``chip_smoke.py`` builds) on the card against the same solve on
    the CPU: poses within 2e-3 (float32 PCG, reductions in another
    order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from chip_smoke import _two_by_288
    from cslam_tpu_torch.pgo.solver import lm_optimize
    res = {}
    for device in ("cuda", "cpu"):
        arrays = _two_by_288(device)
        assert arrays.num_nodes == 1024
        res[device] = lm_optimize(arrays, torch.ones(
            arrays.num_edges, device=device), max_iters=15)
    np.testing.assert_allclose(res["cuda"].poses.cpu().numpy()[:576],
                               res["cpu"].poses.numpy()[:576], atol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 16])
def test_bank_scan_on_augmented_ring_keys_matches_plain_version(B):
    """K1 on the scan-context bank's fused stage 1: augmented ring-key rows
    ``[rk, ||rk||^2, 0...]`` (non-unit, D = 32) against ``[2q, -1, 0...]``
    queries, k = 10, bit for bit with its plain version on the small path
    (B = 1) and the screen path (B = 16); the indices are the euclidean
    shortlist's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from cslam_tpu_torch.matching import scancontext_bank as scb
    from cslam_tpu_torch.ops import topk as topk_ops
    rng = np.random.default_rng(4)
    scans = (rng.random((8192, 20, 60), dtype=np.float32)
             * (rng.random((8192, 20, 60), dtype=np.float32) > 0.7) * 8.0)
    rk = torch.from_numpy(scans.mean(-1)).cuda()
    aug = scb._augment_ring_keys(rk)
    q_rk = rk[rng.integers(0, 8192, B)] + 0.01
    q_aug = scb._augment_queries(q_rk)
    n = 8000
    before = nns.launches
    gv, gi = nns.cosine_topk_scan(aug, n, q_aug, 10)
    assert nns.launches == before + 1
    rv, ri = nns.cosine_topk_scan_ref(aug, n, q_aug, 10)
    assert torch.equal(gi, ri) and torch.equal(gv, rv)
    _, ei = topk_ops.euclidean_topk(rk, (rk * rk).sum(-1), n, q_rk, 10)
    assert torch.equal(gi[:, 0], ei[:, 0])


@pytest.mark.cuda
def test_verify_pair_batch_on_card_matches_cpu():
    """One 8-pair verification chunk at pad_size 1024 (``chip_smoke.py``'s:
    4 revisits, 4 cross-scene pairs) on the card and on the CPU: equal
    success flags, transforms within 1e-3 rad and 1e-2 m."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import math

    from chip_smoke import _verify_pairs
    from cslam_tpu_torch.ops import registration as reg
    pairs, _ = _verify_pairs(np.random.default_rng(3))
    out = {d: reg.compute_transform_batch(pairs, 0.4, 40, pad_size=1024,
                                          device=d) for d in ("cuda", "cpu")}
    assert [s for _, s in out["cuda"]] == [s for _, s in out["cpu"]] \
        == [True] * 4 + [False] * 4
    for (Zc, ok), (Zh, _) in zip(out["cuda"], out["cpu"]):
        if ok:
            dR = Zc[:3, :3].T @ Zh[:3, :3]
            angle = math.acos(min(1.0, max(-1.0, (np.trace(dR) - 1) / 2)))
            assert angle <= 1e-3
            assert np.abs(Zc[:3, 3] - Zh[:3, 3]).max() <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["gnc_align_batch", "gnc_pnp_batch"])
def test_visual_verification_chunk_on_card_matches_cpu(solver):
    """One 16-pair visual verification chunk (``chip_smoke.py``'s, at
    ``benchmarks/verification_bench.py``'s widths) on the card and on the
    CPU: equal inlier counts, transforms within 1e-4 of each other."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from chip_smoke import _VIS_CAM, _verification_chunks
    from cslam_tpu_torch.ops import visual_registration as vreg
    rigid, pnp, _ = _verification_chunks(np.random.default_rng(0))
    cam = [_VIS_CAM[k] for k in ("fx", "fy", "cx", "cy")]
    out = {}
    for dev in ("cuda", "cpu"):
        if solver == "gnc_align_batch":
            T, inl = vreg.gnc_align_batch(*rigid, 0.3, device=dev)
        else:
            T, inl = vreg.gnc_pnp_batch(*pnp, *cam, device=dev)
        out[dev] = (T.cpu(), inl.cpu())
    assert torch.equal(out["cuda"][1], out["cpu"][1])
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=0,
                               atol=1e-4)


@pytest.mark.cuda
def test_tier_graphs_capture_once_and_keep_earlier_outputs():
    """``utils.tier_graphs.TierGraphs`` on the card: one capture per key
    (shapes, dtypes, static keywords), replays with new operands equal to
    the eager function, and an earlier replay's outputs untouched by a
    later one (a caller launches several chunks of one tier before it
    reads any)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    from cslam_tpu_torch.utils.tier_graphs import TierGraphs

    def fn(x, scale, k):
        return (x * scale).cumsum(-1)[..., :k], (x > 0).sum(-1)
    graphs = TierGraphs(fn, "test")
    a = torch.arange(12.0, device="cuda").view(3, 4) - 5.0
    scale = torch.tensor(2.0, device="cuda")
    first = graphs("cuda", a, scale, k=3)
    second = graphs("cuda", -a, scale * 3, k=3)
    assert (graphs.captures, graphs.replays) == (1, 2)
    for got, want in zip(first + second, fn(a, scale, 3) + fn(-a, scale * 3,
                                                               3)):
        assert torch.equal(got, want)
    graphs("cuda", a, scale, k=2)
    graphs("cuda", a[:2], scale, k=3)
    assert graphs.captures == 3 and graphs.keys_seen == 3


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["dense", "pcg"])
def test_graphed_lm_matches_eager_on_card(tier):
    """``lm_optimize`` at GNC's first solve (30 iterations, ``rel_tol``
    1e-5) replayed from the tier's CUDA graphs against the same step
    programs launched eagerly (``eager=True``), twice: LM iterations equal,
    CG iterations within 1% and the final cost within 1e-5 relative of
    the eager runs', poses within 2e-3 of each (the card-against-CPU limit
    of ``test_pcg_lm_optimize_on_card_matches_cpu``: ``index_add_`` on the
    card sums by atomics, and on this graph eager runs alone land 1.2e-3
    apart in two clusters, graphed runs in either). A second solve with
    other caps, tolerances and weights captures nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    import dataclasses

    from chip_smoke import _two_by_288
    from cslam_tpu_torch.pgo import solver
    arrays = _two_by_288("cuda")
    if tier == "dense":      # the first robot's 288 poses: a 512 tier
        n = 288
        keep = (arrays.edge_i < n) & (arrays.edge_j < n)
        arrays = dataclasses.replace(
            arrays, poses=arrays.poses[:512],
            node_valid=(torch.arange(512, device="cuda") < n).to(
                arrays.node_valid.dtype),
            edge_valid=arrays.edge_valid * keep,
            edge_i=torch.where(keep, arrays.edge_i, 0),
            edge_j=torch.where(keep, arrays.edge_j, 0))
    graphs = (solver.DENSE_GRAPHS if tier == "dense"
              else solver.PCG_GRAPHS)
    w = torch.ones(arrays.num_edges, device="cuda")
    graphed, *eager = [solver.lm_optimize(arrays, w, max_iters=30,
                                          rel_tol=1e-5, eager=e)
                       for e in (False, True, True)]
    assert (graphed.cg_iterations > 0) == (tier == "pcg")
    for ref in eager:
        assert graphed.iterations == ref.iterations
        assert abs(graphed.cg_iterations - ref.cg_iterations) <= (
            0.01 * ref.cg_iterations)
        assert float(graphed.final_cost) == pytest.approx(
            float(ref.final_cost), rel=1e-5)
        assert float((graphed.poses - ref.poses).abs().max()) <= 2e-3
    captures = graphs.captures
    w2 = w.clone()
    w2[:5] = 0.5
    res = solver.lm_optimize(arrays, w2, max_iters=3, cg_iters=40,
                             rel_tol=1e-5, cg_tol=1e-4, init_lambda=1e-3)
    assert res.iterations <= 3 and graphs.captures == captures


def _stagger_problem(robots=3):
    """``tests/test_torch_distributed_pgo.py``'s three robots (noisy
    odometry, inits off by 0.3 m per robot index, an intra loop closure
    every 7 poses), whose local LM solves stop at different iterations."""
    from cslam_tpu_torch.pgo.distributed import ShardedPoseGraph
    rng = np.random.default_rng(3)
    sig = np.array([0.01] * 3 + [0.1] * 3)
    p = ShardedPoseGraph(robots)
    for r in range(robots):
        cur = np.eye(4)
        p.add_variable(r, 0, cur)
        for k in range(23):
            z = np.eye(4)
            z[0, 3] = 1.0
            z[:3, 3] += rng.normal(scale=0.05 * (r + 1), size=3)
            init = cur @ z
            init[:3, 3] += rng.normal(scale=0.3 * (r + 1), size=3)
            p.add_variable(r, k + 1, init)
            p.add_local_between(r, k, k + 1, z, sig)
            cur = init
        for k in range(0, 16, 7):
            z = np.eye(4)
            z[0, 3] = 8.0
            p.add_local_between(r, k, k + 8, z, sig, robust=True)
    return p


@pytest.mark.cuda
def test_graphed_batched_lm_matches_eager_on_card():
    """``distributed._batched_lm`` on :func:`_stagger_problem`, one LM
    iteration replayed from its CUDA graphs against the same step launched
    eagerly: poses within 2e-3, the LM's card-against-CPU limit
    (``test_pcg_lm_optimize_on_card_matches_cpu``). The card's atomic sums
    differ in the last bits and the dense float32 Cholesky of these weakly
    anchored chains carries that to about 1e-4 m in one step; from the
    second step on, an accept/reject decision taken on nearly equal costs
    can go either way in either mode (4.8e-3 m apart after 3 steps), so
    one step is compared."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    from cslam_tpu_torch.pgo import distributed
    from cslam_tpu_torch.utils.robot_mesh import StackedMesh
    local, _ = _stagger_problem().to_device_arrays(StackedMesh(3, "cuda"))
    w = torch.ones(local.edge_i.shape, device="cuda")
    (graphed, iters), (eager, eager_iters) = [
        distributed._batched_lm(local, w, max_iters=1, eager=e)
        for e in (False, True)]
    assert iters.tolist() == eager_iters.tolist() == [1] * 3
    assert float((graphed - eager).abs().max()) <= 2e-3
    assert float((graphed - local.poses).abs().max()) > 1e-2
    assert distributed.BATCHED_GRAPHS.captures >= 2


def _symmetric_cases(rng):
    """Random symmetric float32 matrices, n = 1 .. 16, with spread,
    clustered and repeated eigenvalues, and LOBPCG-like Gram matrices."""
    out = []
    for n in (1, 2, 4, 7, 12, 16):
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        for lam in (rng.standard_normal(n) * 10.0,
                    1.0 + 1e-4 * rng.standard_normal(n),
                    np.repeat([3.0, -1.0], (n + 1) // 2)[:n],
                    np.logspace(-6, 5, n)):
            out.append(((Q * lam) @ Q.T).astype(np.float32))
    return out


@pytest.mark.cuda
def test_small_eigh_matches_plain_version_on_card():
    """The Jacobi kernel against ``torch.linalg.eigh`` on the card:
    eigenvalues within 16 float32 eps of max |lambda|, eigenvectors
    |<v, v_plain>| >= 1 - 1e-4 where the gap to the neighbours is at least
    1e-3 of max |lambda|, V orthonormal, its sign rule, and NaN for a NaN
    input; one launch per call, counted by the wrapper and on the
    device."""
    from cslam_tpu_torch.ops import small_linalg as sl
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.default_rng(5)
    sl.reset_launches()
    calls = 0
    for a in _symmetric_cases(rng):
        A = torch.from_numpy(a).cuda()
        w, V = sl.eigh_descending(A)
        calls += 1
        wr, Vr = sl.eigh_descending_ref(A)
        scale = float(wr.abs().max()) or 1.0
        eps = float(torch.finfo(torch.float32).eps)
        assert float((w - wr).abs().max()) <= 16 * eps * scale
        n = a.shape[0]
        assert torch.allclose(V.T @ V, torch.eye(n, device="cuda"),
                              atol=1e-5)
        idx = V.abs().argmax(dim=0)
        assert bool((V[idx, torch.arange(n)] > 0).all())
        for j in range(n):
            gaps = [abs(float(wr[j] - wr[i])) for i in (j - 1, j + 1)
                    if 0 <= i < n]
            if all(g >= 1e-3 * scale for g in gaps):
                assert abs(float(V[:, j] @ Vr[:, j])) >= 1 - 1e-4
    batch = torch.from_numpy(np.stack(_symmetric_cases(rng)[4:8])).cuda()
    w, V = sl.eigh_descending(batch)
    calls += 1
    wr, _ = sl.eigh_descending_ref(batch)
    assert float((w - wr).abs().max()) <= 16 * eps * float(wr.abs().max())
    bad = torch.eye(4, device="cuda")
    bad[2, 1] = float("nan")
    w, V = sl.eigh_descending(bad)
    calls += 1
    assert bool(w.isnan().all()) and bool(V.isnan().all())
    assert sl.eigh_launches == calls
    assert sl.device_launch_counts()["eigh"] == calls


@pytest.mark.cuda
def test_small_eigh_matches_jacobi_mirror_bit_for_bit_on_card():
    """The parallel-order Jacobi kernel against ``eigh_jacobi_ref`` (its
    arithmetic in torch float64, run on the CPU copy of the input): the
    same bits at n = 1 .. 16, one matrix and a batch of four per size."""
    from cslam_tpu_torch.ops import small_linalg as sl
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.default_rng(9)
    for n in range(1, 17):
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        mats = np.stack([((Q * lam) @ Q.T).astype(np.float32) for lam in (
            rng.standard_normal(n) * 10.0, 1.0 + 1e-4 * rng.standard_normal(n),
            np.repeat([3.0, -1.0], (n + 1) // 2)[:n], np.logspace(-6, 5, n))])
        for A in (mats[0], mats):
            w, V = sl.eigh_descending(torch.from_numpy(A).cuda())
            wr, Vr = sl.eigh_jacobi_ref(torch.from_numpy(A))
            assert torch.equal(w.cpu(), wr) and torch.equal(V.cpu(), Vr), n


@pytest.mark.cuda
def test_woodbury_apply_matches_plain_version_on_card():
    """The apply with no triangular solve, ``Tinv x - Z (Z^T x)``, against
    ``woodbury_inverse_ref`` (two per apply) on the card at P = 1024:
    within 32 float32 eps of max |Tinv x|, the size of the terms both forms
    subtract."""
    from cslam_tpu_torch.ops import fiedler as fd
    from cslam_tpu_torch.ops import highest_precision
    from cslam_tpu_torch.selection.mac import MAC, mac_kwargs_from_params
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n, fixed, cands = _slam_mac_inputs()
    mac = MAC(fixed, cands, n, device="cuda", **mac_kwargs_from_params({}))
    pre = mac._pre
    M = pre["U"].shape[1] - 1
    lr_w = torch.full((M,), 0.5, device="cuda")
    chol = fd.woodbury_factor(pre["G"], lr_w, lr_w.new_full(
        (1,), 1.0 / pre["sigma"]))
    x = torch.randn((pre["Tinv"].shape[0], 12), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    args = (pre["Tinv"], pre["U"], pre["Y"], chol)
    new = highest_precision(lambda: fd.woodbury_inverse(*args)(x))()
    ref = highest_precision(lambda: fd.woodbury_inverse_ref(*args)(x))()
    scale = float((pre["Tinv"] @ x).abs().max())
    eps = float(torch.finfo(torch.float32).eps)
    assert float((new - ref).abs().max()) <= 32 * eps * scale


@pytest.mark.cuda
def test_small_svd_matches_plain_version_on_card():
    """The one-sided Jacobi SVD against ``torch.linalg.svd`` on the card:
    singular values within 16 float32 eps of the largest, the product
    U diag(S) Vh and the polar factor U Vh (what LOBPCG's basis extension
    uses) within 1e-5, U and Vh orthonormal, also for a rank-deficient
    block; and bit for bit against ``svd_jacobi_ref`` (its arithmetic in
    torch float64, run on the CPU copy of the input), one matrix at a time
    and as one batch of every 4 x 4 case."""
    from cslam_tpu_torch.ops import small_linalg as sl
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.default_rng(6)
    eps = float(torch.finfo(torch.float32).eps)
    cases = [rng.standard_normal((n, n)).astype(np.float32)
             for n in (1, 2, 4, 9, 16)]
    X, _ = np.linalg.qr(rng.standard_normal((200, 4)))
    cases.append(X[:4].astype(np.float32))     # _extend_basis's Xupper
    low = rng.standard_normal((4, 4)).astype(np.float32)
    low[:, 3] = 0.0
    cases.append(low)
    for a in cases:
        A = torch.from_numpy(a).cuda()
        U, S, Vh = sl.svd(A)
        Ur, Sr, Vhr = sl.svd_ref(A)
        n = a.shape[0]
        assert float((S - Sr).abs().max()) <= 16 * eps * float(Sr.max())
        assert torch.allclose((U * S) @ Vh, A, atol=1e-5)
        eye = torch.eye(n, device="cuda")
        assert torch.allclose(U.T @ U, eye, atol=1e-5)
        assert torch.allclose(Vh @ Vh.T, eye, atol=1e-5)
        if float(Sr.min()) > 1e-3:
            assert torch.allclose(U @ Vh, Ur @ Vhr, atol=1e-5)
        mirror = sl.svd_jacobi_ref(A.cpu())
        assert all(torch.equal(x.cpu(), m) for x, m in zip((U, S, Vh), mirror))
    batch = torch.from_numpy(np.stack([a for a in cases if a.shape[0] == 4]))
    got = sl.svd(batch.cuda())
    mirror = sl.svd_jacobi_ref(batch)
    assert all(torch.equal(x.cpu(), m) for x, m in zip(got, mirror))


@pytest.mark.cuda
def test_small_svd_matches_jacobi_mirror_bit_for_bit_on_card():
    """The round-robin one-sided Jacobi SVD kernel against
    ``svd_jacobi_ref`` at n = 1 .. 16: Gaussian, clustered and graded
    blocks and one with a zero column (the completion), one at a time and
    as one batch per size."""
    from cslam_tpu_torch.ops import small_linalg as sl
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.default_rng(10)
    for n in range(1, 17):
        P, _ = np.linalg.qr(rng.standard_normal((n, n)))
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        zero = rng.standard_normal((n, n))
        zero[:, n // 2] = 0.0
        mats = np.stack([rng.standard_normal((n, n)),
                         (P * (1.0 + 1e-4 * rng.standard_normal(n))) @ Q.T,
                         (P * np.logspace(-6, 0, n)) @ Q.T,
                         zero]).astype(np.float32)
        for A in (mats[0], mats[3], mats):
            got = sl.svd(torch.from_numpy(A).cuda())
            want = sl.svd_jacobi_ref(torch.from_numpy(A))
            assert all(torch.equal(x.cpu(), m)
                       for x, m in zip(got, want)), n


@pytest.mark.cuda
def test_step_graphs_while_loop_stops_on_device():
    """``StepGraphs.run_while``: one launch repeats a captured program
    while its flag is set, with no iteration past the stop, and a second
    launch with new operands does the same; equal to the eager loop."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    from cslam_tpu_torch.utils.tier_graphs import StepGraphs

    def init(s, o):
        zero = torch.zeros((), dtype=torch.int32, device=o["n"].device)
        return {"i": zero, "acc": zero.clone().float(),
                "go": o["n"] > 0}

    def step(s, o):
        i = s["i"] + s["go"].to(torch.int32)
        acc = torch.where(s["go"], s["acc"] + 0.5 * i, s["acc"])
        return {"i": i, "acc": acc, "go": s["go"] & (i < o["n"])}

    graphs = StepGraphs("while_test", {"init": init, "step": step})
    for n in (7, 0, 3):
        out = {}
        for eager in (False, True):
            with graphs.solve("cuda", {"n": torch.tensor(
                    n, dtype=torch.int32, device="cuda")},
                    eager=eager) as loop:
                loop.run("init")
                loop.run_while("step", "go")
                out[eager] = [t.item() for t in loop.take("i", "acc")]
        assert out[False] == out[True] == [n, 0.25 * n * (n + 1)]
    assert graphs.by_program["step"]["captures"] == 1


@pytest.mark.cuda
def test_step_graphs_nested_plan_on_card():
    """``StepGraphs.run_plan``: an outer loop whose body holds an inner
    loop (WHILE nodes nested in one launch) gives the eager plan's
    counts, for several operands, with one capture per program."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    from cslam_tpu_torch.utils.tier_graphs import StepGraphs

    def init(s, o):
        zero = torch.zeros((), dtype=torch.int32, device=o["n"].device)
        return {"i": zero, "total": zero.clone(), "outer": o["n"] > 0}

    def start(s, o):
        return {"j": torch.zeros_like(s["i"]), "inner": s["i"] >= 0}

    def step(s, o):
        j = s["j"] + 1
        return {"j": j, "total": s["total"] + s["i"] * j,
                "inner": j <= s["i"]}

    def end(s, o):
        i = s["i"] + 1
        return {"i": i, "outer": i < o["n"]}

    graphs = StepGraphs("plan_test", {"init": init, "start": start,
                                      "step": step, "end": end})
    plan = ("init", ("outer", ("start", ("inner", ("step",)), "end")))
    for n in (4, 0, 6):
        out = {}
        for eager in (False, True):
            with graphs.solve("cuda", {"n": torch.tensor(
                    n, dtype=torch.int32, device="cuda")},
                    eager=eager) as loop:
                loop.run_plan(plan)
                out[eager] = [t.item() for t in loop.take("i", "total")]
        want = sum(i * j for i in range(n) for j in range(1, i + 2))
        assert out[False] == out[True] == [n, want]
    assert all(c["captures"] == 1 for c in graphs.by_program.values())
    assert graphs.while_launches == 3


def _dist_problem(robots=3, poses=32, sep_every=8):
    from cslam_tpu_torch.tools import distributed_pgo_bench as bench
    gt, problem, _, n_sep = bench.build(robots, poses,
                                        np.random.default_rng(0), sep_every)
    return gt, problem, n_sep


@pytest.mark.cuda
@pytest.mark.parametrize("dense_max", [512, 16])
def test_graphed_distributed_solve_matches_eager_on_card(dense_max,
                                                          monkeypatch):
    """``distributed_optimize`` on a ``StackedMesh`` of the card: the plan
    launched once (dense tier; with ``_DENSE_SOLVE_MAX_NODES`` at 16, the
    batched PCG tier) against the same programs launched eagerly: the
    same sweeps, separators on the same side of 0.5, both outliers out,
    positions within 1e-2 m (the GNC graduation's limit: the card's
    atomic sums round differently); a second solve of the key captures
    nothing and makes no host read before its results."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    from cslam_tpu_torch.pgo import distributed, solver
    from cslam_tpu_torch.utils.robot_mesh import StackedMesh
    monkeypatch.setattr(solver, "_DENSE_SOLVE_MAX_NODES", dense_max)
    gt, problem, n_sep = _dist_problem()
    mesh = StackedMesh(3, "cuda")
    runs = {}
    for mode in ("graphed", "eager", "graphed"):
        before = (distributed.DIST_GRAPHS.captures,
                  distributed.DIST_GRAPHS.while_launches)
        est, info = distributed.distributed_optimize(
            problem, mesh, sweeps=30, lm_iters=8, cg_iters=60,
            return_info=True, _eager=mode == "eager")
        runs.setdefault(mode, []).append(
            (est, info, distributed.DIST_GRAPHS.captures - before[0],
             distributed.DIST_GRAPHS.while_launches - before[1]))
    (g1, g2), (e,) = runs["graphed"], runs["eager"]
    assert g2[2] == 0 and g2[3] == 1 and e[3] == 0
    for est, info, _, _ in (g1, g2):
        assert info.sweeps_used == e[1].sweeps_used
        np.testing.assert_array_equal(info.sep_weights > 0.5,
                                      e[1].sep_weights > 0.5)
        assert np.all(info.sep_weights[n_sep:n_sep + 2] < 0.5)
        diff = max(np.abs(est[k][:3, 3] - e[0][k][:3, 3]).max()
                   for k in est)
        assert diff <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("poses", [200, 60])
def test_graphed_mac_selection_matches_eager_on_card(poses):
    """MAC's FW loop replayed from its captured programs (Woodbury tier at
    3 x 200 poses, dense at 3 x 60) against the same programs launched
    one by one: the same selection and FW iterations, the relaxed iterate
    within 1e-4 and the dual bound within 1e-3 relative (cuBLAS may pick
    other kernels for a capture than for an eager call, and LOBPCG's
    float32 stop test is at rounding level); two graphed runs bit for bit
    alike. Host reads: one status per FW iteration plus the last (dense:
    plus each evaluation's eager eigensolve); the Woodbury tier's LOBPCG
    runs through the small-eigensolver kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cslam_tpu_torch.ops import small_linalg
    from cslam_tpu_torch.selection.mac import MAC, mac_kwargs_from_params
    n, fixed, cands = _slam_mac_inputs(poses=poses)
    kw = mac_kwargs_from_params({})
    w0 = np.zeros(len(cands))
    w0[:5] = 1.0
    out = {}
    for eager in (True, False, False):
        mac = MAC(fixed, cands, n, device="cuda", **kw)
        small_linalg.reset_launches()
        sel, w, dual = mac.fw_subset(w0, 5, max_iters=20, eager=eager)
        loop = dict(mac.last_loop)
        out.setdefault(eager, []).append(
            (sel, w, dual, loop, small_linalg.device_launch_counts()))
    (sel_e, w_e, dual_e, loop_e, _), = out[True]
    (sel_a, w_a, dual_a, loop_a, _), (sel_b, w_b, dual_b, loop_b, _) = \
        out[False]
    np.testing.assert_array_equal(w_a, w_b)
    assert dual_a == dual_b and loop_a == loop_b
    for sel, w, dual, loop, launches in out[False]:
        np.testing.assert_array_equal(sel, sel_e)
        assert loop["it"] == loop_e["it"]
        np.testing.assert_allclose(w, w_e, atol=1e-4)
        assert dual == pytest.approx(dual_e, rel=1e-3)
        if mac._dense:
            assert loop["host_reads"] <= 3 * loop["it"] + 1
        else:
            assert loop["host_reads"] <= loop["it"] + 1
            assert loop["lobpcg_iters"] > 0 and loop["lobpcg_masked"] == 0
            assert launches["eigh"] > 0 and launches["svd"] > 0


@pytest.mark.cuda
def test_no_selection_capture_after_warmup_on_card():
    """``warmup_selection_tiers`` captures every program a selection of
    the warmed tiers replays: selections at P = 512 (dense) and 1024
    (Woodbury) after it capture nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cslam_tpu_torch.selection import mac as mac_mod
    kw = mac_mod.mac_kwargs_from_params({"frontend.mac_p_floor": 512})
    mac_mod.warmup_selection_tiers(600, 60, device="cuda", **kw)
    graphs = (mac_mod.DENSE_FW_GRAPHS, mac_mod.WOODBURY_FW_GRAPHS)
    before = [g.captures for g in graphs]
    for poses in (150, 200):
        n, fixed, cands = _slam_mac_inputs(poses=poses)
        m = mac_mod.MAC(fixed, cands, n, device="cuda", **kw)
        m.fw_subset(np.zeros(len(cands)), 5, max_iters=20)
    assert [g.captures for g in graphs] == before


@pytest.mark.cuda
def test_selection_prefetch_captures_in_a_thread_on_card():
    """ACM's tier prefetch (``prefetch_selection_tier_async``) captures a
    new tier's programs in its own thread (``thread_local`` capture mode,
    under the program set's lock); a selection of that tier afterwards
    captures nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import threading

    from cslam_tpu_torch.selection import mac as mac_mod
    kw = mac_mod.mac_kwargs_from_params({"frontend.mac_p_floor": 2048})
    n, fixed, cands = _slam_mac_inputs(poses=300)
    before = mac_mod.WOODBURY_FW_GRAPHS.captures
    mac_mod.prefetch_selection_tier_async(n, len(cands), 1, device="cuda",
                                          **kw)
    for t in threading.enumerate():
        if t.name.startswith("mac-prefetch-"):
            t.join(timeout=300)
            assert not t.is_alive()
    captured = mac_mod.WOODBURY_FW_GRAPHS.captures
    assert captured > before
    m = mac_mod.MAC(fixed, cands, n, device="cuda", **kw)
    assert m._P == 2048
    m.fw_subset(np.zeros(len(cands)), 5, max_iters=20)
    assert mac_mod.WOODBURY_FW_GRAPHS.captures == captured
