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
here it is a host loop over eager device ops (``k`` is a plain int).
"""
from __future__ import annotations

import logging
from typing import List, Sequence, Tuple

import numpy as np
import torch

from cslam_tpu_torch import resolve_device
from cslam_tpu_torch.ops import fiedler as fd
from cslam_tpu_torch.ops import highest_precision
from cslam_tpu_torch.ops.topk import topk_ties_ascending
from cslam_tpu_torch.types import Edge
from cslam_tpu_torch.utils import device_read, profiling

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


def _round_mask(w, cw, cmask, k: int):
    """One-hot rounding of a relaxed iterate: top-k of w with a small
    original-weight tie-break (ties of the score by ascending index)."""
    score = torch.where(cmask > 0, w + 1e-6 * cw,
                        torch.full_like(w, -float("inf")))
    _, idx = topk_ties_ascending(score, k)
    mask = torch.zeros_like(w)
    mask[idx] = 1.0
    return mask


def _fw_while_loop(eval_fn, w0, cmask, k: int, max_iters: int, tol: float,
                   aux0=None, round_eval_fn=None, cw=None):
    """The Frank-Wolfe loop as a host loop (the JAX package's one traced
    ``lax.while_loop``): evaluate (lambda_2, supergradient), one-hot top-k
    direction, dual upper-bound update, duality-gap early stop BEFORE the
    step, step size alpha = 2/(it+2). Returns (relaxed w, dual, iterations).

    ``eval_fn(w, aux) -> (f, grad, aux)`` may carry solver state across
    iterations through ``aux`` (the warm-started LOBPCG Ritz block).

    ``round_eval_fn(mask, aux) -> lambda_2`` enables best-rounded-iterate
    tracking: each iterate's rounding is evaluated (with the carried
    ``aux`` as a start, which rounded evaluations do not update) and the
    best one seen, the initialization included, is returned. As in the JAX
    loop, the iteration that meets the gap evaluates its (unstepped)
    iterate's rounding too.
    """
    E = w0.shape[0]
    keep = torch.arange(E, device=w0.device) < k
    aux = aux0
    f_best = (round_eval_fn(_round_mask(w0, cw, cmask, k), aux)
              if round_eval_fn is not None else -float("inf"))
    w, w_best = w0, w0
    dual = torch.tensor(float("inf"), device=w0.device)
    it = 0
    while it < max_iters:
        f, grad, aux = eval_fn(w, aux)
        g = torch.where(cmask > 0, grad, torch.full_like(grad, -float("inf")))
        _, idx = topk_ties_ascending(g, E)
        s = torch.zeros_like(w)
        s[idx[keep]] = 1.0
        dual = torch.minimum(
            dual, f + torch.sum(torch.where(cmask > 0, grad * (s - w),
                                            torch.zeros_like(w))))
        it += 1
        done = bool(dual - f < tol)
        if not done:
            alpha = 2.0 / (float(it - 1) + 2.0)
            w = w + alpha * (s - w)
        if round_eval_fn is not None:
            f_r = round_eval_fn(_round_mask(w, cw, cmask, k), aux)
            if bool(f_r > f_best):
                w_best, f_best = w, f_r
        if done:
            break
    if round_eval_fn is not None:
        return w_best, dual, it
    return w, dual, it


@highest_precision
def _dense_fw_loop(L_fixed, active, ci, cj, cw, w0, cmask, tol: float,
                   k: int, max_iters: int, best_rounding: bool = False):
    P = L_fixed.shape[0]

    def eval_fn(w, aux):
        return (*_dense_fw_step(L_fixed, active, ci, cj, cw, w), aux)

    round_eval_fn = None
    if best_rounding:
        def round_eval_fn(mask, aux):
            Lr = L_fixed + fd.laplacian_from_edges(ci, cj, mask * cw, P)
            return fd.fiedler_pair(Lr, active)[0]

    return _fw_while_loop(eval_fn, w0, cmask, k, max_iters, tol,
                          round_eval_fn=round_eval_fn, cw=cw)


@highest_precision
def _woodbury_fw_loop(pre, active, chain_i, chain_j, chain_w, lr_i, lr_j,
                      lr_w_fixed, ci, cj, cw, w0, cmask, tol: float, k: int,
                      max_iters: int, lobpcg_iters: int,
                      lobpcg_short_iters: int = 14, warm_ritz: bool = False,
                      lobpcg_warm_iters: int = 6,
                      best_rounding: bool = False):
    def objective(lr_w, v):
        return (fd.rayleigh_quotient(chain_i, chain_j, chain_w, v)
                + fd.rayleigh_quotient(lr_i, lr_j, lr_w, v))

    def eval_fn(w, aux):
        lr_w = torch.cat([lr_w_fixed, w * cw])
        if warm_ritz:
            # carry the Ritz block across FW iterations: successive
            # Laplacians differ only by the alpha * (s - w) step, so the
            # previous block is a near-converged start for a short first
            # stage; the residual-gated continuation covers the cold first
            # iteration and a stale block
            _, v, aux = fd.fiedler_pair_chain_lowrank(
                pre, lr_w, active, lobpcg_iters=lobpcg_iters,
                short_iters=lobpcg_warm_iters, X0=aux, return_block=True)
        else:
            _, v = fd.fiedler_pair_chain_lowrank(
                pre, lr_w, active, lobpcg_iters=lobpcg_iters,
                short_iters=lobpcg_short_iters)
        diff = v[ci] - v[cj]
        return objective(lr_w, v), cw * diff * diff, aux

    round_eval_fn = None
    if best_rounding:
        def round_eval_fn(mask, aux):
            lr_w = torch.cat([lr_w_fixed, mask * cw])
            # the carried block starts the rounded solve but is not
            # updated by it: rounded matrices jump more than the relaxed
            # alpha-step sequence
            _, v = fd.fiedler_pair_chain_lowrank(
                pre, lr_w, active, lobpcg_iters=lobpcg_iters,
                short_iters=(lobpcg_warm_iters if warm_ritz
                             else lobpcg_short_iters),
                X0=aux if warm_ritz else None)
            return objective(lr_w, v)

    aux0 = fd._start_block(active.shape[0], 4, active) if warm_ritz else None
    return _fw_while_loop(eval_fn, w0, cmask, k, max_iters, tol, aux0=aux0,
                          round_eval_fn=round_eval_fn, cw=cw)


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


def prefetch_selection_tier_async(num_poses: int, num_candidates: int,
                                  num_fixed_loops: int = 0,
                                  max_iters: int = 20,
                                  **mac_kwargs) -> None:
    """Same signature as the JAX package's tier prefetch; does nothing.

    The JAX package compiles one FW program per padded shape tier and
    prefetches the next tier's compile in a thread. Eager PyTorch compiles
    nothing per shape, so there is nothing to prefetch.
    """


def warmup_selection_tiers(expected_poses: int, expected_candidates: int,
                           max_iters: int = 20, **mac_kwargs) -> None:
    """Same signature as the JAX package's tier warmup; does nothing
    (eager PyTorch compiles no per-tier program)."""


def selection_tier_grid(expected_poses: int, expected_candidates: int,
                        e_floor: int = _E_FLOOR, p_floor: int = 64):
    """Every (pose tier, candidate tier) pair the JAX package's warmup
    covers, kept for API parity; the port warms nothing per tier."""
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


def warmup_selection_tier(p: int, e: int, max_iters: int = 20,
                          **mac_kwargs) -> None:
    """Same signature as the JAX package's one-tier warmup; does nothing
    (eager PyTorch compiles no per-tier program)."""


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

    def fw_subset_dispatch(self, w_init: np.ndarray, k: int,
                           max_iters: int = 5,
                           duality_gap_tol: float = 1e-8):
        """Run the FW loop and start the copy of its result to the host;
        returns ``(w, dual, k, iterations)`` for :meth:`fw_subset_finish`.

        The host loop reads one scalar per iteration (the duality-gap
        test), so unlike the JAX package's single fused dispatch this call
        returns when the loop has run; only the final read is deferred. An
        eigensolver failure is deferred too: :meth:`fw_subset_finish`
        raises it as ``np.linalg.LinAlgError``, where the ACM retry ladder
        catches numeric failures."""
        k = min(k, self._m)
        w0 = np.zeros(self._E, np.float32)
        w0[:self._m] = np.asarray(w_init, np.float32)
        w0 = torch.from_numpy(w0).to(self.device)
        cmask = (torch.arange(self._E, device=self.device)
                 < self._m).float()
        tol = float(np.float32(duality_gap_tol))
        with profiling.span("mac.fw_dispatch"):
            try:
                if self._dense:
                    w, dual, it = _dense_fw_loop(
                        self._L_fixed, self._active, self._ci, self._cj,
                        self._cw, w0, cmask, tol, k=k, max_iters=max_iters,
                        best_rounding=self._best_rounding)
                else:
                    w, dual, it = _woodbury_fw_loop(
                        self._pre, self._active, self._chain_i,
                        self._chain_j, self._chain_w, self._lr_i,
                        self._lr_j, self._lr_w_fixed, self._ci, self._cj,
                        self._cw, w0, cmask, tol, k=k, max_iters=max_iters,
                        lobpcg_iters=self._lobpcg_iters,
                        lobpcg_short_iters=self._lobpcg_short_iters,
                        warm_ritz=self._fw_warm_ritz,
                        lobpcg_warm_iters=self._lobpcg_warm_iters,
                        best_rounding=self._best_rounding)
            except torch.linalg.LinAlgError as exc:
                return exc, None, k, 0
            device_read.prefetch((w, dual))
        return w, dual, k, it

    #: FW iterations consumed by the last harvested solve
    last_fw_iters: int = -1

    def fw_subset_finish(self, pending
                         ) -> Tuple[np.ndarray, np.ndarray, float]:
        """Materialize a :meth:`fw_subset_dispatch` result and round it."""
        w, dual, k, it = pending
        if isinstance(w, torch.linalg.LinAlgError):
            raise np.linalg.LinAlgError(str(w))
        with profiling.span("mac.fw_read"):
            w_host = device_read.to_numpy(w)[:self._m].astype(np.float64)
            dual = float(device_read.to_numpy(dual))
            self.last_fw_iters = int(it)
        if self._best_rounding:
            # the selection is EXACTLY the mask whose objective the loop
            # measured when it chose this iterate
            return (self._round_mask_host(w_host.astype(np.float32),
                                          k)[:self._m],
                    w_host, dual)
        return (self.round_solution_tiebreaker(w_host, k), w_host, dual)

    def fw_subset(self, w_init: np.ndarray, k: int, max_iters: int = 5,
                  duality_gap_tol: float = 1e-8
                  ) -> Tuple[np.ndarray, np.ndarray, float]:
        """Frank-Wolfe subset selection (reference ``mac.py:191-233``).

        Returns (rounded selection, relaxed w, dual upper bound).
        """
        if self._m == 0:
            return np.zeros(0), np.zeros(0), 0.0
        return self.fw_subset_finish(self.fw_subset_dispatch(
            w_init, k, max_iters=max_iters,
            duality_gap_tol=duality_gap_tol))

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
