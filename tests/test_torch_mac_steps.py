"""MAC's Frank-Wolfe loop and LOBPCG as step programs
(``selection/mac.py``, ``ops/lobpcg.py``) against the host-driven loops
they replace, on the CPU.

The oracle is the loops as they were written before the step programs:
LOBPCG's ``while i < m and converged < k`` read on the host each
iteration, the residual gate read on the host, and the Frank-Wolfe loop
with its duality-gap test, best-rounding comparison and one-hot direction
decided on the host (copied below, built from the same numeric pieces).
The step programs replace every host decision by a ``torch.where`` on a
flag of the loop state, so on one torch thread the results must agree BIT
FOR BIT: the relaxed iterate, the dual bound, the FW iterations, the
selected edges and LOBPCG's stop iteration, for LOBPCG blocks of 1, 3 and
the default number of iterations per program. A NaN from an eigensolve
surfaces as ``np.linalg.LinAlgError`` from ``fw_subset_finish``. About 25
s on one worker.
"""
import numpy as np
import pytest
import torch

from cslam_tpu_torch.ops import fiedler as fd
from cslam_tpu_torch.ops import highest_precision, small_linalg
from cslam_tpu_torch.ops import lobpcg as lb
from cslam_tpu_torch.ops.topk import topk_ties_ascending
from cslam_tpu_torch.selection import mac as tmac
from cslam_tpu_torch.types import Edge
from torch_threads import one_torch_thread  # noqa: F401

_FLOORS = {"frontend.mac_e_floor": 256, "frontend.mac_mf_floor": 64}


# -- the host-driven loops (the oracle) --------------------------------------

def _host_lobpcg(A, X, m, tol=None):
    n, k = X.shape
    tol = float(torch.finfo(X.dtype).eps) if tol is None else tol
    X = lb._orthonormalize(X)
    P = lb._extend_basis(X, X.shape[1])
    AX = A(X)
    theta = torch.sum(X * AX, dim=0, keepdim=True)
    R = AX - theta * X
    i = converged = 0
    while i < m and converged < k:
        R = lb._project_out(torch.cat((X, P), dim=1), R)
        XPR = torch.cat((X, P, R), dim=1)
        theta, Q = lb._rayleigh_ritz_orth(A, XPR)
        B = Q[:, :k]
        B = B / torch.linalg.norm(B, dim=0, keepdim=True)
        X = XPR @ B
        X = X / torch.linalg.norm(X, dim=0, keepdim=True)
        q, _ = torch.linalg.qr(Q[:k, k:].T)
        P = XPR @ (Q[:, k:] @ q)
        normP = torch.linalg.norm(P, dim=0, keepdim=True)
        P = P / torch.where(normP == 0, torch.ones_like(normP), normP)
        AX = A(X)
        R = AX - theta[None, :k] * X
        resid_norms = torch.linalg.norm(R, dim=0)
        reltol = (torch.linalg.norm(AX, dim=0) + theta[:k]) * n * 10
        converged = int(torch.sum(resid_norms < tol * reltol))
        theta = theta[None, :k]
        i += 1
    return theta[0, :], X, i


def _host_chain_lowrank(pre, lr_w, active, lobpcg_iters, short_iters,
                        X0=None, resid_tol=1e-4):
    chol = fd.woodbury_factor(pre["G"], lr_w,
                              lr_w.new_full((1,), 1.0 / pre["sigma"]))
    A = fd.woodbury_inverse(pre["Tinv"], pre["U"], pre["Y"], chol)
    if X0 is None:
        X0 = fd._start_block(active.shape[0], 4, active)
    if short_iters >= lobpcg_iters:
        theta, V, _ = _host_lobpcg(A, X0, lobpcg_iters)
    else:
        theta, V, _ = _host_lobpcg(A, X0, short_iters)
        if bool(fd.residual_ratio(A, theta, V) > resid_tol):
            theta, V, _ = _host_lobpcg(A, V, lobpcg_iters - short_iters)
    return fd.fiedler_from_ritz(theta, V, active)[1], V


def _host_round_mask(w, cw, cmask, k):
    score = torch.where(cmask > 0, w + 1e-6 * cw,
                        torch.full_like(w, -float("inf")))
    _, idx = topk_ties_ascending(score, k)
    mask = torch.zeros_like(w)
    mask[idx] = 1.0
    return mask


@highest_precision
def _host_fw(m, w_init, k, max_iters, tol=1e-8):
    """The Frank-Wolfe loop with every decision read on the host."""
    k = min(k, m._m)
    E = m._E
    w = torch.zeros(E)
    w[:m._m] = torch.from_numpy(np.asarray(w_init, np.float32))
    cmask = (torch.arange(E) < m._m).float()
    tol = float(np.float32(tol))
    static = m._woodbury_static() if not m._dense else {}
    short = static.get("short_iters")
    warm = m._fw_warm_ritz

    def evaluate(weights, aux, update_aux):
        if m._dense:
            Lw = m._L_fixed + fd.laplacian_from_edges(
                m._ci, m._cj, weights * m._cw, m._P)
            lam2, v = fd.fiedler_pair(Lw, m._active)
            return lam2, v, aux
        lr_w = torch.cat([m._lr_w_fixed, weights * m._cw])
        v, V = _host_chain_lowrank(m._pre, lr_w, m._active, m._lobpcg_iters,
                                   short, X0=aux if warm else None)
        f = (fd.rayleigh_quotient(m._chain_i, m._chain_j, m._chain_w, v)
             + fd.rayleigh_quotient(m._lr_i, m._lr_j, lr_w, v))
        return f, v, (V if update_aux else aux)

    aux = fd._start_block(m._P, 4, m._active) if warm else None
    best = m._best_rounding
    f_best = -float("inf")
    if best:
        f_best = evaluate(_host_round_mask(w, m._cw, cmask, k), aux,
                          False)[0]
    w_best, dual, it = w, torch.tensor(float("inf")), 0
    keep = torch.arange(E) < k
    while it < max_iters:
        f, v, aux = evaluate(w, aux, True)
        diff = v[m._ci] - v[m._cj]
        grad = m._cw * diff * diff
        g = torch.where(cmask > 0, grad, torch.full_like(grad, -float("inf")))
        _, idx = topk_ties_ascending(g, E)
        s = torch.zeros_like(w)
        s[idx[keep]] = 1.0
        dual = torch.minimum(dual, f + torch.sum(torch.where(
            cmask > 0, grad * (s - w), torch.zeros_like(w))))
        it += 1
        done = bool(dual - f < tol)
        if not done:
            w = w + 2.0 / (float(it - 1) + 2.0) * (s - w)
        if best:
            f_r = evaluate(_host_round_mask(w, m._cw, cmask, k), aux,
                           False)[0]
            if bool(f_r > f_best):
                w_best, f_best = w, f_r
        if done:
            break
    return (w_best if best else w), dual, it


# -- inputs ------------------------------------------------------------------

def _graph(P, rng, nb_cands=60):
    """Four robot chains at tier ``P`` with loops between them and
    candidates of distinct weights."""
    poses = P * 3 // 4
    per = poses // 4
    fixed = [Edge(r * per + i, r * per + i + 1, 1.0)
             for r in range(4) for i in range(per - 1)]
    fixed += [Edge(r * per + per - 1, (r + 1) * per + 3, 0.8)
              for r in range(3)]
    cands = []
    while len(cands) < nb_cands:
        i, j = (int(x) for x in rng.integers(0, 4 * per, 2))
        if abs(i - j) > 1:
            cands.append(Edge(i, j, float(rng.uniform(0.1, 1.0))))
    return fixed, cands, 4 * per


@pytest.fixture(scope="module")
def graphs():
    rng = np.random.default_rng(4)
    return {"dense": _graph(128, rng), "woodbury": _graph(1024, rng)}


def _mac(graphs, tier, **params):
    fixed, cands, n = graphs[tier]
    p = {**_FLOORS, "frontend.mac_p_floor": 1024 if tier == "woodbury"
         else 64, **params}
    return tmac.MAC(fixed, cands, n, device="cpu",
                    **tmac.mac_kwargs_from_params(p))


# -- tests -------------------------------------------------------------------

@pytest.mark.parametrize("block", [1, 3, None])
@pytest.mark.parametrize("m", [3, 30])
def test_lobpcg_steps_match_host_loop(m, block):
    """LOBPCG's step functions, run in blocks of ``block`` masked steps
    (a stopped state passes through unchanged), against the host loop:
    the same Ritz values, block and stop iteration, bit for bit."""
    rng = np.random.default_rng(m)
    n = 200
    A = rng.standard_normal((n, n)).astype(np.float32)
    At = torch.from_numpy((A + A.T) / 2)
    X0 = torch.from_numpy(rng.standard_normal((n, 4)).astype(np.float32))
    op = lambda x: At @ x  # noqa: E731
    theta, X, i = _host_lobpcg(op, X0, m)
    st = lb.lobpcg_init(op, X0, m)
    while bool(st["active"]):
        for _ in range(block or tmac._LOBPCG_BLOCK):
            st = lb.lobpcg_step(op, st)
    assert int(st["i"]) == i
    assert torch.equal(st["theta"][0], theta) and torch.equal(st["X"], X)
    t2, X2, i2 = lb.lobpcg_standard(op, X0, m=m)
    assert i2 == i and torch.equal(t2, theta) and torch.equal(X2, X)


@pytest.mark.parametrize("block", [1, 3, None])
@pytest.mark.parametrize("tier,params", [
    ("dense", {}),
    ("woodbury", {}),
    ("woodbury", {"frontend.mac_fw_warm_ritz": False,
                  "frontend.mac_best_rounding": False}),
])
def test_fw_programs_match_host_loop(graphs, tier, params, block,
                                     monkeypatch):
    """The step-program FW loop (run eagerly here) against the host loop:
    the relaxed iterate, the dual bound, the FW iterations and the
    selected edges bit for bit; also with a duality-gap tolerance that
    stops it before its iteration cap."""
    if block is not None:
        monkeypatch.setattr(tmac, "_LOBPCG_BLOCK", block)
    m = _mac(graphs, tier, **params)
    w0 = np.zeros(m._m)
    w0[:4] = 1.0
    # the gap met after 10 FW iterations (dense 0.1, Woodbury 0.01)
    for tol, iters in ((1e-8, 6), (0.1 if tier == "dense" else 0.01, 20)):
        w_h, dual_h, it_h = _host_fw(m, w0, 4, iters, tol)
        sel, w, dual = m.fw_subset(w0, 4, max_iters=iters,
                                   duality_gap_tol=tol)
        assert m.last_fw_iters == it_h == m.last_loop["it"]
        np.testing.assert_array_equal(
            w, w_h.numpy()[:m._m].astype(np.float64))
        assert dual == float(dual_h)
        if m._best_rounding:
            np.testing.assert_array_equal(
                sel, m._round_mask_host(w_h.numpy(), 4)[:m._m])
        # one status read per FW iteration (plus the last); on the dense
        # tier also one per eager eigensolve
        bound = it_h + 1 if tier == "woodbury" else 3 * it_h + 1
        assert m.last_loop["host_reads"] <= bound


@pytest.mark.parametrize("tier", ["dense", "woodbury"])
def test_eigensolver_nan_raises_linalg_error(graphs, tier, monkeypatch):
    """An eigensolve that returns NaN (the kernel's failure on the card)
    does not raise inside the loop: the NaN stays in the state and
    ``fw_subset_finish`` raises ``np.linalg.LinAlgError``, which ACM's
    retry ladder catches."""
    m = _mac(graphs, tier)
    if tier == "woodbury":
        def nan_eigh(A):
            w, V = small_linalg.eigh_descending_ref(A)
            return torch.full_like(w, float("nan")), V
        monkeypatch.setattr(small_linalg, "eigh_descending", nan_eigh)
    else:
        eigh = torch.linalg.eigh

        def nan_eigh(A):
            w, V = eigh(A)
            return w, torch.full_like(V, float("nan"))
        monkeypatch.setattr(torch.linalg, "eigh", nan_eigh)
    pending = m.fw_subset_dispatch(np.zeros(m._m), 3, max_iters=3)
    with pytest.raises(np.linalg.LinAlgError):
        m.fw_subset_finish(pending)


def test_step_graphs_serialize_solves_per_key():
    """``StepGraphs.solve`` holds one lock per key: a second solve of the
    same key (sharing its state buffers) waits, while a solve of another
    key, such as ACM's prefetch of the next selection tier in its own
    thread, does not wait for it."""
    import threading

    from cslam_tpu_torch.utils.tier_graphs import StepGraphs
    graphs = StepGraphs("lock_test", {"init": lambda s, o: {"x": 2 * o["a"]}})
    key4, key8 = {"a": torch.ones(4)}, {"a": torch.ones(8)}
    held, release, done = (threading.Event(), threading.Event(),
                           threading.Event())

    def hold():
        with graphs.solve("cpu", key4):
            held.set()
            release.wait(10)

    def solve(operands):
        with graphs.solve("cpu", operands) as loop:
            loop.run("init")
        done.set()
    threads = [threading.Thread(target=hold)]
    threads[0].start()
    assert held.wait(10)
    threads.append(threading.Thread(target=solve, args=(key8,)))
    threads[-1].start()
    assert done.wait(10)            # another key: not blocked
    done.clear()
    threads.append(threading.Thread(target=solve, args=(key4,)))
    threads[-1].start()
    assert not done.wait(0.3)       # the same key: waits for the holder
    release.set()
    assert done.wait(10)
    for t in threads:
        t.join(10)
