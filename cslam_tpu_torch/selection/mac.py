"""Maximization of Algebraic Connectivity (MAC) via Frank-Wolfe.

Counterpart of ``cslam_tpu/selection/mac.py`` (reference
``cslam/mac/mac.py``): maximize ``lambda_2(L(w))`` over relaxed edge
selections ``w in [0,1]^m, |w| <= k`` with Frank-Wolfe, then round.

Math preserved from the reference:
- supergradient grad_k = weight_k * (v_i - v_j)^2 from the Fiedler vector v
  (``mac.py:112-130``, eq. (8) of arXiv:2203.13897),
- direction step = top-k one-hot rounding of the gradient (``mac.py:132-147``),
- dual upper bound u = min(u, f + grad @ (s - w)) with duality-gap early stop
  (``mac.py:209-230``),
- step size alpha = 2/(it+2) (``mac.py:229``),
- final rounding with (w, weight) lexicographic tie-break (``mac.py:168-189``),
  or, with best rounding, the rounding of the best-scoring iterate.

The per-iteration Fiedler eigensolve has the two tiers of
:mod:`cslam_tpu_torch.ops.fiedler`: the dense deflated ``eigh`` up to a
padded pose tier of 512, and above it the exact Woodbury shift-invert
(tridiagonal odometry chains + low-rank loop closures) with LOBPCG, whose
Ritz block can be carried across Frank-Wolfe iterations (``fw_warm_ritz``).

The JAX package runs the whole FW loop as one compiled ``lax.while_loop``;
here it is step programs over one loop state, captured once per selection
tier and replayed (see the note above :func:`_fw_init`).
"""
from __future__ import annotations

import logging
import threading
from typing import List, Sequence, Tuple

import numpy as np
import torch

from cslam_tpu_torch import resolve_device
from cslam_tpu_torch.ops import fiedler as fd
from cslam_tpu_torch.ops import highest_precision
from cslam_tpu_torch.ops.lobpcg import lobpcg_init, lobpcg_step
from cslam_tpu_torch.ops.topk import topk_ties_ascending
from cslam_tpu_torch.types import Edge
from cslam_tpu_torch.utils import device_read, profiling
from cslam_tpu_torch.utils.tier_graphs import StepGraphs, host_operands

_DENSE_MAX_NODES = 512  # above this, use the chain + low-rank solver

_E_FLOOR = 1024   # candidate-edge tier floor
_MF_FLOOR = 512   # non-chain fixed-edge (verified loop) tier floor

_SEEN_TIERS: set = set()  # (P, E, mf) triples logged once per process
_logger = logging.getLogger(__name__)


def _tier(n: int, minimum: int = 64) -> int:
    t = minimum
    while t < n:
        t *= 2
    return t


def _pad_edges(edges: Sequence[Edge], size: int):
    i = np.zeros(size, np.int64)
    j = np.zeros(size, np.int64)
    w = np.zeros(size, np.float32)
    for idx, e in enumerate(edges):
        i[idx], j[idx], w[idx] = e.i, e.j, e.weight
    return i, j, w


def _dense_fw_step(L_fixed, active, ci, cj, cw, w):
    """One FW evaluation on the dense tier: (lambda_2, supergradient)."""
    P = L_fixed.shape[0]
    Lw = L_fixed + fd.laplacian_from_edges(ci, cj, w * cw, P)
    lam2, v = fd.fiedler_pair(Lw, active)
    diff = v[ci] - v[cj]
    return lam2, cw * diff * diff


def _woodbury_fw_step(pre, active, chain_i, chain_j, chain_w, lr_i, lr_j,
                      lr_w_fixed, ci, cj, cw, w, lobpcg_iters: int,
                      lobpcg_short_iters: int = 14):
    """One FW evaluation on the chain + low-rank tier.

    The low-rank block is [fixed loop closures | candidates]; only the
    candidate weights change between calls, so the precompute in ``pre``
    serves the whole Frank-Wolfe loop.
    """
    lr_w = torch.cat([lr_w_fixed, w * cw])
    _, v = fd.fiedler_pair_chain_lowrank(
        pre, lr_w, active, lobpcg_iters=lobpcg_iters,
        short_iters=lobpcg_short_iters)
    # exact objective at v: the Rayleigh quotient over the real edges
    # (the inverted spectrum's eps shift would cancel digits)
    lam2 = (fd.rayleigh_quotient(chain_i, chain_j, chain_w, v)
            + fd.rayleigh_quotient(lr_i, lr_j, lr_w, v))
    diff = v[ci] - v[cj]
    return lam2, cw * diff * diff


def _round_mask(w, cw, cmask, k):
    """One-hot rounding of a relaxed iterate: top-k of w with a small
    original-weight tie-break (ties of the score by ascending index). ``k``
    is a 0-d tensor: the whole padded tier is ranked and the first ``k``
    kept, so one program serves every budget."""
    E = w.shape[0]
    score = torch.where(cmask > 0, w + 1e-6 * cw,
                        torch.full_like(w, -float("inf")))
    _, idx = topk_ties_ascending(score, E)
    keep = (torch.arange(E, device=w.device) < k).to(w.dtype)
    return torch.zeros_like(w).scatter(0, idx, keep)


# ---------------------------------------------------------------------------
# The Frank-Wolfe loop as step programs
# ---------------------------------------------------------------------------
#
# The JAX package runs each selection as one ``lax.while_loop`` (its stop
# test, the duality gap, on the device) holding the eigensolves: on the
# Woodbury tier JAX's ``lobpcg_standard`` loop and its residual-gated second
# stage. Here the loop is cut into step programs over one state dict
# (``utils.tier_graphs.StepGraphs``), captured once per selection tier and
# replayed:
#
# - every update is a ``torch.where`` on a flag of the state: ``live`` (the
#   FW loop has not stopped: no gap met, iterations left) for the FW
#   programs, ``lactive`` for LOBPCG, so a program run after its loop's
#   stop changes no bit;
# - each LOBPCG stage is one launch: its iteration (``_LOBPCG_BLOCK``
#   masked steps) is the body of a CUDA graph WHILE node on ``lactive``
#   (``StepGraphs.run_while``), so the stage stops on the device with no
#   host read and no iteration past its stop;
# - the host reads one status per FW iteration, the next iteration queued
#   first (an iteration after the stop is masked); on the dense tier each
#   evaluation's eager ``torch.linalg.eigh`` (cuSOLVER's Jacobi, which
#   reads the host itself) sits between two programs;
# - a NaN from an eigensolve stays in the state (``bad``) and
#   :meth:`MAC.fw_subset_finish` raises it as ``np.linalg.LinAlgError``.

_LOBPCG_BLOCK = 1   # LOBPCG iterations per run of the stage's body
_STATUS_SLOTS = ("stopped", "it", "lobpcg_calls", "lobpcg_iters",
                 "lobpcg_masked", "evaluations", "done", "bad")


def _status(s) -> torch.Tensor:
    return torch.stack([(~s["live"]).to(torch.int32), s["it"],
                        s["lobpcg_calls"], s["lobpcg_iters"],
                        s["lobpcg_masked"], s["evaluations"],
                        s["done"].to(torch.int32), s["bad"].to(torch.int32)])


def _fw_init(s, o, best_rounding=False, **_):
    """The loop state before the first FW iteration; with best rounding
    ``live`` first covers the initial rounded evaluation."""
    w0 = o["w0"]
    dev = w0.device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    false = torch.zeros((), dtype=torch.bool, device=dev)
    out = {"w": w0.clone(), "w_best": w0.clone(),
           "dual": torch.full((), float("inf"), device=dev),
           "f_best": torch.full((), -float("inf"), device=dev),
           "it": zero, "done": false,
           "live": (torch.ones((), dtype=torch.bool, device=dev)
                    if best_rounding else o["max_iters"] > 0),
           "bad": false.clone(), "lobpcg_calls": zero.clone(),
           "lobpcg_iters": zero.clone(), "lobpcg_masked": zero.clone(),
           "evaluations": zero.clone()}
    if "x0" in o:
        out["aux"] = o["x0"].clone()
    out["status"] = _status(out)
    return out


def _fw_update(s, o, f, grad) -> dict:
    """An FW iteration after its evaluation ``(f, grad)``: the one-hot top-k
    direction, the dual upper bound, the gap test BEFORE the step, the step
    ``alpha = 2 / (it + 2)``; masked by ``live``."""
    w, cmask, live = s["w"], o["cmask"], s["live"]
    E = w.shape[0]
    g = torch.where(cmask > 0, grad, torch.full_like(grad, -float("inf")))
    _, idx = topk_ties_ascending(g, E)
    keep = (torch.arange(E, device=w.device) < o["k"]).to(w.dtype)
    direction = torch.zeros_like(w).scatter(0, idx, keep)
    dual = torch.minimum(
        s["dual"], f + torch.sum(torch.where(
            cmask > 0, grad * (direction - w), torch.zeros_like(w))))
    done = dual - f < o["tol"]
    # alpha rounded from float64, as a Python float scalar is
    alpha = (2.0 / (s["it"].double() + 2.0)).float()
    w_new = torch.where(done, w, w + alpha * (direction - w))
    return {"w": torch.where(live, w_new, w),
            "dual": torch.where(live, dual, s["dual"]),
            "it": s["it"] + live.to(torch.int32),
            "done": torch.where(live, done, s["done"]),
            "bad": s["bad"] | (live & ~torch.isfinite(f)),
            "evaluations": s["evaluations"] + live.to(torch.int32)}


def _fw_end(s, o, upd: dict) -> dict:
    """``live`` for the next FW iteration and the status."""
    now = {**s, **upd}
    upd["live"] = s["live"] & ~now["done"] & (now["it"] < o["max_iters"])
    upd["status"] = _status({**now, **upd})
    return upd


def _round_best(s, o, f_r, first: bool) -> dict:
    """Best-rounded-iterate tracking after a rounded evaluation ``f_r``
    (the first one, of the initial iterate, sets ``f_best``)."""
    live = s["live"]
    better = live & (torch.ones_like(live) if first else f_r > s["f_best"])
    upd = {"w_best": torch.where(better, s["w"], s["w_best"]),
           "f_best": torch.where(better, f_r, s["f_best"]),
           "bad": s["bad"] | (live & ~torch.isfinite(f_r)),
           "evaluations": s["evaluations"] + live.to(torch.int32)}
    if first:
        upd["live"] = o["max_iters"] > 0
        upd["status"] = _status({**s, **upd})
        return upd
    return _fw_end(s, o, upd)


# -- dense tier: two programs around an eager eigh per evaluation ----------

def _dense_pre(s, o, **_):
    """The deflated Laplacian of the relaxed iterate (``fiedler_pair``'s
    matrix)."""
    P = o["L_fixed"].shape[0]
    Lw = o["L_fixed"] + fd.laplacian_from_edges(o["ci"], o["cj"],
                                                s["w"] * o["cw"], P)
    return {"B": fd.deflated_laplacian(Lw, o["active"])}


def _dense_pre_round(s, o, **_):
    """The deflated Laplacian of the iterate's rounding."""
    P = o["L_fixed"].shape[0]
    mask = _round_mask(s["w"], o["cw"], o["cmask"], o["k"])
    Lr = o["L_fixed"] + fd.laplacian_from_edges(o["ci"], o["cj"],
                                                mask * o["cw"], P)
    return {"B": fd.deflated_laplacian(Lr, o["active"])}


def _dense_post(s, o, best_rounding=False, **_):
    v = s["eig_v"] * o["active"].float()
    diff = v[o["ci"]] - v[o["cj"]]
    upd = _fw_update(s, o, s["eig_w"], o["cw"] * diff * diff)
    if best_rounding:
        return upd
    return _fw_end(s, o, upd)


def _dense_post_round0(s, o, **_):
    return _round_best(s, o, s["eig_w"], first=True)


def _dense_post_round(s, o, **_):
    return _round_best(s, o, s["eig_w"], first=False)


DENSE_FW_GRAPHS = StepGraphs("mac_dense", {
    "init": _fw_init, "pre": _dense_pre, "pre_round": _dense_pre_round,
    "post": _dense_post, "post_round0": _dense_post_round0,
    "post_round": _dense_post_round})


def _dense_eigh(loop) -> None:
    """The eager eigensolve between two dense programs (a library call
    that reads its error flag on the host on the card)."""
    eigvals, eigvecs = torch.linalg.eigh(loop.state["B"])
    loop.put(eig_w=eigvals[0], eig_v=eigvecs[:, 0])


@highest_precision
def _run_dense(loop, max_iters: int, best_rounding: bool) -> tuple:
    """Drive the dense programs; returns (status, host reads)."""
    reads = 0
    loop.run("init")
    if best_rounding:
        loop.run("pre_round")
        _dense_eigh(loop)
        loop.run("post_round0")
        reads += 1
    status = None
    for _ in range(max_iters):
        loop.run("pre")
        _dense_eigh(loop)
        loop.run("post")
        reads += 1
        if best_rounding:
            loop.run("pre_round")
            _dense_eigh(loop)
            loop.run("post_round")
            reads += 1
        status = loop.status().wait()
        reads += 1
        if status[0]:
            break
    if status is None:
        status = loop.status().wait()
        reads += 1
    return status, reads


# -- Woodbury tier: LOBPCG stages as guarded programs ----------------------

_LOBPCG_KEYS = ("X", "P", "R", "theta", "i", "conv", "m", "active")


def _lobpcg_state(s) -> dict:
    return {k: s["l" + k] for k in _LOBPCG_KEYS}


def _b_inverse(s, o):
    return fd.woodbury_apply(o["Tinv"], s["Z"])


def _wb_setup(s, o, round_: bool, warm_ritz=False, lobpcg_iters=48,
              short_iters=14, **_):
    """Factor the capacitance for this evaluation's weights (the relaxed
    iterate, or its rounding), form the apply's ``Z`` from the factor and
    start LOBPCG's first stage."""
    cand = (_round_mask(s["w"], o["cw"], o["cmask"], o["k"]) if round_
            else s["w"])
    lr_w = torch.cat([o["lr_w_fixed"], cand * o["cw"]])
    Z = fd.woodbury_z(o["Y"], fd.woodbury_factor(o["G"], lr_w,
                                                  o["cinv_sigma"]))
    x0 = s["aux"] if warm_ritz else o["x0"]
    st = lobpcg_init(fd.woodbury_apply(o["Tinv"], Z), x0,
                     min(short_iters, lobpcg_iters), enabled=s["live"])
    return {"lr_w": lr_w, "Z": Z,
            "lobpcg_calls": s["lobpcg_calls"] + s["live"].to(torch.int32),
            **{"l" + k: v for k, v in st.items()}}


def _wb_setup_relaxed(s, o, **static):
    return _wb_setup(s, o, False, **static)


def _wb_setup_round(s, o, **static):
    return _wb_setup(s, o, True, **static)


def _wb_lobpcg(s, o, block=_LOBPCG_BLOCK, **_):
    """``block`` LOBPCG iterations (each masked by ``lactive``)."""
    return _lobpcg_iterations(s, _b_inverse(s, o), block)


def _lobpcg_iterations(s, A, block=_LOBPCG_BLOCK) -> dict:
    """The body of :func:`_wb_lobpcg` on the operator ``A`` (``chip_smoke.py``
    also runs it on the plain apply, ``fd.woodbury_inverse_ref``)."""
    st = _lobpcg_state(s)
    iters, masked = s["lobpcg_iters"], s["lobpcg_masked"]
    for _ in range(block):
        act = st["active"].to(torch.int32)
        iters, masked = iters + act, masked + (1 - act)
        st = lobpcg_step(A, st)
    return {"lobpcg_iters": iters, "lobpcg_masked": masked,
            **{"l" + k: v for k, v in st.items()}}


def _wb_gate(s, o, lobpcg_iters=48, short_iters=14,
             resid_tol=fd.RESID_TOL, **_):
    """The residual gate after the first stage and, where it is passed,
    the second stage's start from the first's Ritz block."""
    A = _b_inverse(s, o)
    st = _lobpcg_state(s)
    rel = fd.residual_ratio(A, st["theta"][0], st["X"])
    cont = s["live"] & (rel > resid_tol)
    st2 = lobpcg_init(A, st["X"], lobpcg_iters - short_iters, enabled=cont)
    return {"lobpcg_calls": s["lobpcg_calls"] + cont.to(torch.int32),
            **{"l" + k: torch.where(cont, st2[k], st[k])
               for k in _LOBPCG_KEYS}}


def _wb_objective(s, o):
    """The evaluation's Fiedler vector and the exact objective at it: the
    Rayleigh quotient over the real edges (the inverted spectrum's eps
    shift would cancel digits)."""
    _, v = fd.fiedler_from_ritz(s["ltheta"][0], s["lX"], o["active"])
    f = (fd.rayleigh_quotient(o["chain_i"], o["chain_j"], o["chain_w"], v)
         + fd.rayleigh_quotient(o["lr_i"], o["lr_j"], s["lr_w"], v))
    return f, v


def _wb_finish(s, o, warm_ritz=False, best_rounding=False, **_):
    f, v = _wb_objective(s, o)
    diff = v[o["ci"]] - v[o["cj"]]
    upd = _fw_update(s, o, f, o["cw"] * diff * diff)
    if warm_ritz:
        # carry the Ritz block across FW iterations: successive Laplacians
        # differ only by the alpha * (s - w) step, so the previous block is
        # a near-converged start for a short first stage; the
        # residual-gated continuation covers the cold first iteration and
        # a stale block
        upd["aux"] = torch.where(s["live"], s["lX"], s["aux"])
    if best_rounding:
        return upd
    return _fw_end(s, o, upd)


def _wb_finish_round0(s, o, **_):
    return _round_best(s, o, _wb_objective(s, o)[0], first=True)


def _wb_finish_round(s, o, **_):
    # the carried block starts the rounded solve but is not updated by it:
    # rounded matrices jump more than the relaxed alpha-step sequence
    return _round_best(s, o, _wb_objective(s, o)[0], first=False)


WOODBURY_FW_GRAPHS = StepGraphs("mac_woodbury", {
    "init": _fw_init, "setup": _wb_setup_relaxed,
    "setup_round": _wb_setup_round, "lobpcg": _wb_lobpcg, "gate": _wb_gate,
    "finish": _wb_finish, "finish_round0": _wb_finish_round0,
    "finish_round": _wb_finish_round})


def _queue_evaluation(loop, setup: str, finish: str, lobpcg_iters: int,
                      short_iters: int) -> None:
    """One evaluation's programs, queued with no host read: the first
    LOBPCG stage, and where there are two stages the gate and the second
    stage, each stage one while loop on ``lactive``."""
    loop.run(setup)
    loop.run_while("lobpcg", "lactive")
    if short_iters < lobpcg_iters:
        loop.run("gate")
        loop.run_while("lobpcg", "lactive")
    loop.run(finish)


@highest_precision
def _run_woodbury(loop, max_iters: int, best_rounding: bool,
                  lobpcg_iters: int, short_iters: int) -> tuple:
    """Drive the Woodbury programs: each FW iteration is queued before the
    previous one's status is read (one read per FW iteration; an
    iteration after the stop is masked). Returns (status, host reads)."""
    def evaluation(setup, finish):
        _queue_evaluation(loop, setup, finish, lobpcg_iters, short_iters)

    loop.run("init")
    if best_rounding:
        evaluation("setup_round", "finish_round0")
    pending, reads = None, 0
    for _ in range(max_iters):
        evaluation("setup", "finish")
        if best_rounding:
            evaluation("setup_round", "finish_round")
        ahead = loop.status()
        if pending is not None:
            reads += 1
            if pending.wait()[0]:
                pending = ahead
                break
        pending = ahead
    if pending is None:
        pending = loop.status()
    return pending.wait(), reads + 1


def mac_kwargs_from_params(params: dict) -> dict:
    """MAC constructor kwargs as production (ACM) resolves them from the
    config tree (same keys and defaults as the JAX package)."""
    return dict(
        lobpcg_short_iters=int(params.get(
            "frontend.mac_lobpcg_short_iters", 14)),
        fw_warm_ritz=bool(params.get("frontend.mac_fw_warm_ritz", True)),
        lobpcg_warm_iters=int(params.get(
            "frontend.mac_lobpcg_warm_iters", 6)),
        best_rounding=bool(params.get(
            "frontend.mac_best_rounding", True)),
        e_floor=int(params.get("frontend.mac_e_floor", _E_FLOOR)),
        mf_floor=int(params.get("frontend.mac_mf_floor", _MF_FLOOR)),
        p_floor=int(params.get("frontend.mac_p_floor", 64)))


_PREFETCHED: set = set()   # tier keys warmed or prefetched in this process
_PREFETCH_LOCK = threading.Lock()
_PREFETCH_THREADS: list = []


def _warmup_macs(p: int, e: int, mf: int, device, **mac_kwargs):
    """A MAC of exactly the (P, E, mf) tier (a chain, ``mf`` picks how many
    non-chain fixed edges; candidates of weight 0, so the duality gap
    closes after one FW iteration: the programs are the same, the weights
    being operands)."""
    fixed = [Edge(i, i + 1, 1.0) for i in range(p - 1)]
    nf = (1 if mf <= mac_kwargs.get("mf_floor", _MF_FLOOR)
          else mf // 2 + 1)
    if p > _DENSE_MAX_NODES:
        fixed += [Edge(i % (p - 2), (i + p // 2) % p, 1.0)
                  for i in range(nf)]
    cands = [Edge(i % (p - 1), (i + p // 3 + 1) % p, 0.0) for i in range(e)]
    return MAC(fixed, cands, p, device=device, **mac_kwargs)


def _warm_tier(p: int, e: int, mf: int, max_iters: int, device,
               **mac_kwargs) -> None:
    m = _warmup_macs(p, e, mf, device, **mac_kwargs)
    # twice with distinct inits, as the JAX package's warmup
    m.fw_subset(np.zeros(m._m), min(4, m._m), max_iters=max_iters)
    m.fw_subset(np.full(m._m, 0.5), min(4, m._m), max_iters=max_iters)


def _tier_key(p, e, mf, device, mac_kwargs):
    return (p, e, mf, str(resolve_device(device)),
            tuple(sorted(mac_kwargs.items())))


def prefetch_selection_tier_async(num_poses: int, num_candidates: int,
                                  num_fixed_loops: int = 0,
                                  max_iters: int = 20, device=None,
                                  **mac_kwargs) -> None:
    """Capture the FW programs for the given sizes' tier in a daemon
    thread (the JAX package compiles its FW program there), so that a
    tier crossing mid-mission replays instead of capturing in the
    foreground. The captures run in ``thread_local`` mode under the tier
    key's lock (``utils.tier_graphs``), as the back end's do, so a
    foreground selection of another tier does not wait for them; the
    thread's selections show in the span table as ``mac.fw_dispatch
    (bg)``.
    Deduplicated per tier key (a tier :func:`warmup_selection_tier`
    warmed is not prefetched again). Does nothing off CUDA: there is
    nothing to capture. A failed prefetch is logged; the tier then
    captures, or raises, at its first use."""
    if resolve_device(device).type != "cuda":
        return
    p = _tier(max(num_poses, 2), minimum=mac_kwargs.get("p_floor", 64))
    e = _tier(max(num_candidates, 1),
              minimum=mac_kwargs.get("e_floor", _E_FLOOR))
    mf = _tier(max(num_fixed_loops, 1),
               minimum=mac_kwargs.get("mf_floor", _MF_FLOOR))
    key = _tier_key(p, e, mf, device, mac_kwargs)
    with _PREFETCH_LOCK:
        if key in _PREFETCHED:
            return
        _PREFETCHED.add(key)

    def capture():
        try:
            _warm_tier(p, e, mf, max_iters, device, **mac_kwargs)
        except Exception:  # noqa: BLE001 - the tier then captures at use
            _logger.warning("MAC tier prefetch (%d, %d, %d) failed", p, e,
                            mf, exc_info=True)

    thread = threading.Thread(target=capture, daemon=True,
                              name=f"mac-prefetch-{p}-{e}-{mf}")
    with _PREFETCH_LOCK:
        _PREFETCH_THREADS.append(thread)
    thread.start()


def wait_for_prefetches() -> None:
    """Return when every prefetch started so far has ended: a caller about
    to synchronize the whole device (a profiler, a shutdown) waits here,
    since a device-wide synchronize during a prefetch's capture fails.
    Call it outside any selection: a prefetch may wait for that tier."""
    with _PREFETCH_LOCK:
        threads = list(_PREFETCH_THREADS)
        _PREFETCH_THREADS.clear()
    for thread in threads:
        thread.join()


def warmup_selection_tiers(expected_poses: int, expected_candidates: int,
                           max_iters: int = 20, device=None,
                           **mac_kwargs) -> None:
    """Capture the Frank-Wolfe programs of every (pose tier, candidate
    tier) up to the expected sizes (:func:`selection_tier_grid`), as the
    JAX package compiles them: the budget ``k``, the weights and
    ``max_iters`` are operands, so one capture per tier serves every
    detection round. ``mac_kwargs`` defaults to the config-default
    production kwargs (:func:`mac_kwargs_from_params`); callers with other
    params pass theirs. On the CPU the programs run eagerly and only
    record their keys (``keys_seen``)."""
    if not mac_kwargs:
        mac_kwargs = mac_kwargs_from_params({})
    for p, e in selection_tier_grid(
            expected_poses, expected_candidates,
            e_floor=mac_kwargs.get("e_floor", _E_FLOOR),
            p_floor=mac_kwargs.get("p_floor", 64)):
        warmup_selection_tier(p, e, max_iters=max_iters, device=device,
                              **mac_kwargs)


def selection_tier_grid(expected_poses: int, expected_candidates: int,
                        e_floor: int = _E_FLOOR, p_floor: int = 64):
    """Every (pose tier, candidate tier) pair ``warmup_selection_tiers``
    covers. The mf axis is not part of the grid: deployments pin it to
    one tier with ``frontend.mac_mf_floor``."""
    grid = []
    p = max(p_floor, 2)
    while True:
        e = e_floor
        while True:
            grid.append((p, e))
            if e >= _tier(max(expected_candidates, 1), minimum=e_floor):
                break
            e *= 2
        if p >= _tier(max(expected_poses, 2), minimum=max(p_floor, 2)):
            break
        p *= 2
    return grid


def warmup_selection_tier(p: int, e: int, max_iters: int = 20, device=None,
                          **mac_kwargs) -> None:
    """Capture ONE (pose tier, candidate tier) FW program set, at the mf
    floor (see :func:`warmup_selection_tiers`)."""
    if not mac_kwargs:
        mac_kwargs = mac_kwargs_from_params({})
    mf = mac_kwargs.get("mf_floor", _MF_FLOOR)
    with _PREFETCH_LOCK:
        _PREFETCHED.add(_tier_key(p, e, mf, device, mac_kwargs))
    _warm_tier(p, e, mf, max_iters, device, **mac_kwargs)


class MAC:
    """Budgeted edge selection by algebraic-connectivity maximization.

    Same surface as the reference solver (``cslam/mac/mac.py:19-33,191-233``):
    fixed measurements define the base graph; candidates carry weights;
    ``fw_subset`` returns a rounded one-hot selection of ``k`` candidates plus
    the relaxed solution and the dual upper bound. The LOBPCG / warm-Ritz
    arguments drive the chain + low-rank tier (pose tiers above 512).
    """

    def __init__(self, fixed_edges: Sequence[Edge],
                 candidate_edges: Sequence[Edge], num_poses: int,
                 lobpcg_iters: int = 48, lobpcg_short_iters: int = 14,
                 fw_warm_ritz: bool = False, lobpcg_warm_iters: int = 6,
                 best_rounding: bool = False,
                 e_floor: int = _E_FLOOR, mf_floor: int = _MF_FLOOR,
                 p_floor: int = 64, device=None):
        self.device = resolve_device(device)
        self.num_poses = num_poses
        self._best_rounding = best_rounding
        self._P = _tier(max(num_poses, 2), minimum=max(p_floor, 2))
        self._E = _tier(max(len(candidate_edges), 1), minimum=e_floor)
        self._m = len(candidate_edges)
        self._mf_floor = mf_floor
        self._lobpcg_iters = lobpcg_iters
        self._lobpcg_short_iters = lobpcg_short_iters
        self._fw_warm_ritz = fw_warm_ritz
        self._lobpcg_warm_iters = lobpcg_warm_iters
        self._dense = self._P <= _DENSE_MAX_NODES
        self.num_lr_fixed = 0  # set by _setup_chain_lowrank on its tier

        dev = self.device
        active = np.zeros(self._P, np.float32)
        active[:num_poses] = 1.0
        self._active = torch.from_numpy(active).to(dev)

        ci, cj, cw = _pad_edges(candidate_edges, self._E)
        self.weights = cw[:self._m]
        self.edge_list = np.stack([ci[:self._m], cj[:self._m]], axis=1)
        self._ci, self._cj, self._cw = (torch.from_numpy(ci).to(dev),
                                        torch.from_numpy(cj).to(dev),
                                        torch.from_numpy(cw).to(dev))
        self._cmask = torch.from_numpy(
            (np.arange(self._E) < self._m).astype(np.float32)).to(dev)

        if self._dense:
            # host (numpy) assembly of the weight-independent fixed
            # Laplacian
            L = np.zeros((self._P, self._P), np.float32)
            for e in fixed_edges:
                w = np.float32(e.weight)
                L[e.i, e.i] += w
                L[e.j, e.j] += w
                L[e.i, e.j] -= w
                L[e.j, e.i] -= w
            self._L_fixed = torch.from_numpy(L).to(dev)
        else:
            self._setup_chain_lowrank(fixed_edges, ci, cj, cw)
        tier = (self._P, self._E, 0 if self._dense else self._mf)
        if tier not in _SEEN_TIERS:
            _SEEN_TIERS.add(tier)
            _logger.info(
                "MAC tier first use: P=%d E=%d mf=%s (poses=%d cands=%d "
                "fixed_loops=%d)", self._P, self._E,
                "dense" if self._dense else self._mf, num_poses, self._m,
                self.num_lr_fixed)

    def _setup_chain_lowrank(self, fixed_edges: Sequence[Edge],
                             ci: np.ndarray, cj: np.ndarray,
                             cw: np.ndarray) -> None:
        """Split the fixed edges into the tridiagonal (|i - j| = 1 odometry
        chain) and the generic low-rank parts, then run the
        weight-independent precompute."""
        chain_w = np.zeros(self._P - 1, np.float32)
        lr_fixed: List[Edge] = []
        for e in fixed_edges:
            if abs(e.i - e.j) == 1:
                chain_w[min(e.i, e.j)] += e.weight
            else:
                lr_fixed.append(e)
        self.num_lr_fixed = len(lr_fixed)
        # the non-chain fixed-edge pad is floored high (``mf_floor``):
        # verified loops accumulate into it during a run
        mf = _tier(max(len(lr_fixed), 1), minimum=self._mf_floor)
        self._mf = mf
        fi, fj, fw = _pad_edges(lr_fixed, mf)

        # sigma must dominate lambda_max over any candidate weighting:
        # Gershgorin with every candidate fully selected
        deg = np.zeros(self._P, np.float64)
        deg[:-1] += chain_w
        deg[1:] += chain_w
        np.add.at(deg, fi, fw)
        np.add.at(deg, fj, fw)
        np.add.at(deg, ci, cw)
        np.add.at(deg, cj, cw)
        sigma = float(np.float32(2.0 * deg.max() + 1.0))

        dev = self.device
        self._chain_i = torch.arange(self._P - 1, device=dev)
        self._chain_j = torch.arange(1, self._P, device=dev)
        self._chain_w = torch.from_numpy(chain_w).to(dev)
        self._lr_i = torch.from_numpy(np.concatenate([fi, ci])).to(dev)
        self._lr_j = torch.from_numpy(np.concatenate([fj, cj])).to(dev)
        self._lr_w_fixed = torch.from_numpy(fw).to(dev)
        self._pre = fd.chain_lowrank_precompute(
            self._chain_w, self._lr_i, self._lr_j, self._active, sigma)
        self._cinv_sigma = torch.full((1,), 1.0 / sigma,
                                      dtype=torch.float32, device=dev)

    # ------------------------------------------------------------------

    @highest_precision
    def _evaluate(self, w_pad: torch.Tensor) -> Tuple[float, np.ndarray]:
        """(lambda_2(L(w)), supergradient) — one eigensolve."""
        if self._dense:
            lam2, grad = _dense_fw_step(self._L_fixed, self._active,
                                        self._ci, self._cj, self._cw, w_pad)
        else:
            lam2, grad = _woodbury_fw_step(
                self._pre, self._active, self._chain_i, self._chain_j,
                self._chain_w, self._lr_i, self._lr_j, self._lr_w_fixed,
                self._ci, self._cj, self._cw, w_pad, self._lobpcg_iters,
                self._lobpcg_short_iters)
        return float(lam2), grad.cpu().numpy()[:self._m]

    def evaluate_objective(self, w: np.ndarray) -> float:
        """lambda_2(L(w)) (reference ``mac.py:99-110``)."""
        w_pad = np.zeros(self._E, np.float32)
        w_pad[:self._m] = w
        return self._evaluate(torch.from_numpy(w_pad).to(self.device))[0]

    def round_solution(self, grad: np.ndarray, k: int) -> np.ndarray:
        """One-hot top-k (direction-finding step, reference ``mac.py:132-147``)."""
        rounded = np.zeros(len(grad))
        if k > 0:
            rounded[np.argpartition(grad, -k)[-k:]] = 1.0
        return rounded

    def round_solution_tiebreaker(self, w: np.ndarray, k: int,
                                  decimal_tol: int = 10) -> np.ndarray:
        """Round relaxed w to k one-hot edges, ties broken by original weight
        (reference ``mac.py:168-189``)."""
        rounded = np.zeros(len(w))
        if k <= 0:
            return rounded
        trunc = np.round(w, decimals=decimal_tol)
        order = np.lexsort((self.weights[:len(w)], trunc))  # ascending
        rounded[order[-k:]] = 1.0
        return rounded

    def _operands(self, w0: np.ndarray, k: int, max_iters: int,
                  tol: float) -> dict:
        """The loop's operands: this MAC's fixed tensors and the
        selection's inputs (pinned host tensors on CUDA)."""
        w0_t, tol_t = host_operands(self.device, w0, np.float32(tol))
        k_t, = host_operands(self.device, k, dtype=torch.int64)
        it_t, = host_operands(self.device, max_iters, dtype=torch.int32)
        ops = {"active": self._active, "ci": self._ci, "cj": self._cj,
               "cw": self._cw, "cmask": self._cmask, "w0": w0_t, "k": k_t,
               "tol": tol_t, "max_iters": it_t}
        if self._dense:
            ops["L_fixed"] = self._L_fixed
            return ops
        pre = self._pre
        ops.update(Tinv=pre["Tinv"], Y=pre["Y"], G=pre["G"],
                   cinv_sigma=self._cinv_sigma, chain_i=self._chain_i,
                   chain_j=self._chain_j, chain_w=self._chain_w,
                   lr_i=self._lr_i, lr_j=self._lr_j,
                   lr_w_fixed=self._lr_w_fixed,
                   x0=fd._start_block(self._P, 4, self._active))
        return ops

    def _woodbury_static(self) -> dict:
        """The Woodbury programs' static keywords (part of their key): the
        first LOBPCG stage is ``lobpcg_warm_iters`` long with the carried
        Ritz block, ``lobpcg_short_iters`` without."""
        return dict(lobpcg_iters=self._lobpcg_iters,
                    short_iters=(self._lobpcg_warm_iters
                                 if self._fw_warm_ritz
                                 else self._lobpcg_short_iters),
                    warm_ritz=self._fw_warm_ritz,
                    best_rounding=self._best_rounding,
                    resid_tol=fd.RESID_TOL, block=_LOBPCG_BLOCK)

    def fw_subset_dispatch(self, w_init: np.ndarray, k: int,
                           max_iters: int = 5,
                           duality_gap_tol: float = 1e-8, *,
                           eager: bool = False):
        """Run the FW loop and start the copy of its result to the host;
        returns the pending result for :meth:`fw_subset_finish`.

        The loop runs as step programs (:data:`DENSE_FW_GRAPHS`,
        :data:`WOODBURY_FW_GRAPHS`), replayed from CUDA graphs on the card
        (``eager`` launches the same programs one by one); the host reads
        one status per FW iteration (plus, on the dense tier, each eager
        eigensolve's error flag), so this call returns when the loop has
        run, and only the read of ``w`` and the dual bound is deferred. An
        eigensolver failure is deferred too: :meth:`fw_subset_finish`
        raises it as ``np.linalg.LinAlgError``, where the ACM retry ladder
        catches numeric failures. The loop's counts are left in
        :attr:`last_loop`."""
        k = min(k, self._m)
        w0 = np.zeros(self._E, np.float32)
        w0[:self._m] = np.asarray(w_init, np.float32)
        operands = self._operands(w0, k, max_iters, duality_gap_tol)
        best = self._best_rounding
        with profiling.span("mac.fw_dispatch"):
            try:
                if self._dense:
                    with DENSE_FW_GRAPHS.solve(
                            self.device, operands, eager=eager,
                            best_rounding=best) as loop:
                        status, reads = _run_dense(loop, max_iters, best)
                        w, dual = loop.take("w_best" if best else "w",
                                            "dual")
                else:
                    static = self._woodbury_static()
                    with WOODBURY_FW_GRAPHS.solve(
                            self.device, operands, eager=eager,
                            **static) as loop:
                        status, reads = _run_woodbury(
                            loop, max_iters, best, self._lobpcg_iters,
                            static["short_iters"])
                        w, dual = loop.take("w_best" if best else "w",
                                            "dual")
            except torch.linalg.LinAlgError as exc:
                return exc, None, k, 0, True
            device_read.prefetch((w, dual))
        self.last_loop = {**dict(zip(_STATUS_SLOTS, status)),
                          "host_reads": reads}
        return w, dual, k, status[1], bool(status[7])

    #: FW iterations consumed by the last harvested solve
    last_fw_iters: int = -1
    #: the last dispatched loop's counts (:data:`_STATUS_SLOTS` and
    #: ``host_reads``)
    last_loop: dict = {}

    def fw_subset_finish(self, pending
                         ) -> Tuple[np.ndarray, np.ndarray, float]:
        """Materialize a :meth:`fw_subset_dispatch` result and round it; a
        loop that met a non-finite objective, iterate or bound raises
        ``np.linalg.LinAlgError``."""
        w, dual, k, it, bad = pending
        if isinstance(w, torch.linalg.LinAlgError):
            raise np.linalg.LinAlgError(str(w))
        with profiling.span("mac.fw_read"):
            w_host = device_read.to_numpy(w)[:self._m].astype(np.float64)
            dual = float(device_read.to_numpy(dual))
            self.last_fw_iters = int(it)
        if bad or not np.all(np.isfinite(w_host)) or (
                it > 0 and not np.isfinite(dual)):
            raise np.linalg.LinAlgError(
                "MAC: an eigensolve gave a non-finite result")
        if self._best_rounding:
            # the selection is EXACTLY the mask whose objective the loop
            # measured when it chose this iterate
            return (self._round_mask_host(w_host.astype(np.float32),
                                          k)[:self._m],
                    w_host, dual)
        return (self.round_solution_tiebreaker(w_host, k), w_host, dual)

    def fw_subset(self, w_init: np.ndarray, k: int, max_iters: int = 5,
                  duality_gap_tol: float = 1e-8, *, eager: bool = False
                  ) -> Tuple[np.ndarray, np.ndarray, float]:
        """Frank-Wolfe subset selection (reference ``mac.py:191-233``).

        Returns (rounded selection, relaxed w, dual upper bound).
        """
        if self._m == 0:
            return np.zeros(0), np.zeros(0), 0.0
        return self.fw_subset_finish(self.fw_subset_dispatch(
            w_init, k, max_iters=max_iters,
            duality_gap_tol=duality_gap_tol, eager=eager))

    def _round_mask_host(self, w: np.ndarray, k: int) -> np.ndarray:
        """numpy mirror of the loop's ``_round_mask``."""
        score = (w[:self._m].astype(np.float32)
                 + np.float32(1e-6) * self.weights.astype(np.float32))
        order = np.argsort(-score, kind="stable")
        mask = np.zeros(self._E, np.float32)
        mask[order[:k]] = 1.0
        return mask

    def fw_subset_host(self, w_init: np.ndarray, k: int, max_iters: int = 5,
                       duality_gap_tol: float = 1e-8
                       ) -> Tuple[np.ndarray, np.ndarray, float]:
        """Host-driven FW loop with numpy bookkeeping (one device step per
        iteration) — the differential oracle for :meth:`fw_subset`."""
        if self._m == 0:
            return np.zeros(0), np.zeros(0), 0.0
        k = min(k, self._m)
        dev = self.device
        w = np.zeros(self._E, np.float32)
        w[:self._m] = np.asarray(w_init, np.float32)
        dual = float("inf")
        w_best, f_best = w.copy(), -np.inf
        if self._best_rounding:
            f_best = self._evaluate(torch.from_numpy(
                self._round_mask_host(w, k)).to(dev))[0]
        for it in range(max_iters):
            f, grad = self._evaluate(torch.from_numpy(w).to(dev))
            s = np.zeros(self._E, np.float32)
            s[:self._m] = self.round_solution(grad, k)
            dual = min(dual, f + float(grad @ (s[:self._m] - w[:self._m])))
            if dual - f < duality_gap_tol:
                break
            alpha = 2.0 / (it + 2.0)
            w = w + alpha * (s - w)
            if self._best_rounding:
                f_r = self._evaluate(torch.from_numpy(
                    self._round_mask_host(w, k)).to(dev))[0]
                if f_r > f_best:
                    w_best, f_best = w.copy(), f_r
        if self._best_rounding:
            w_host = w_best[:self._m].astype(np.float64)
            return (self._round_mask_host(w_best, k)[:self._m], w_host,
                    float(dual))
        w_host = w[:self._m].astype(np.float64)
        return (self.round_solution_tiebreaker(w_host, k), w_host,
                float(dual))
