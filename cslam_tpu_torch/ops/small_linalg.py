"""Small dense eigensolves for LOBPCG: the hand-written CUDA kernels of
``csrc/small_eigh.cu`` and their plain versions.

:func:`eigh_descending` and :func:`svd` take a batch of ``n x n`` float32
matrices, ``n <= MAX_N``. They replace ``torch.linalg.eigh`` (LOBPCG's
Rayleigh-Ritz and SVQB) and ``torch.linalg.svd`` (its basis extension)
on the card, where both read cuSOLVER's error flag on the host after every
call: a loop that holds them can neither run without a host read per
iteration nor be captured in a CUDA graph. No TPU kernel is replaced: the
JAX package compiles the same library calls into its Frank-Wolfe
``lax.while_loop``.

Contract: ``eigh_descending(A) -> (w, V)``, eigenvalues descending, one
eigenvector per column of ``V``, only ``A``'s lower triangle read;
``svd(A) -> (U, S, Vh)`` with ``S`` descending and ``A = U diag(S) Vh``.
The kernels fix each vector's sign (its largest-magnitude entry positive);
the plain versions keep LAPACK's signs, so the port's CPU path is the
library call itself. Every caller is blind to the signs (LOBPCG's bases
and the polar factor ``U Vh`` of ``_extend_basis``), and the comparisons
on the card are too. A kernel's failure is not an exception: a matrix
that does not converge, or holds a NaN or an infinity, gets NaN outputs.

Both kernels run Jacobi in float64 in a parallel (round-robin) order, one
warp per matrix: eigh two-sided with a row of A per lane, the SVD
one-sided (Hestenes) with a column of A per lane, each lane taking its
partner's columns by shuffle and summing the pair's norms and dot product
itself, with no reduction across lanes. :func:`eigh_jacobi_ref` and
:func:`svd_jacobi_ref` repeat their arithmetic in torch float64 (pair
order, entry and sum orders, skip and stop tests, correctly rounded square
roots, sort, sign, completion and NaN rules), so that the tests can check
that arithmetic on the CPU and ``chip_smoke.py`` can hold each kernel to
its mirror bit for bit. The mirrors are never on the main path: the plain
version a CPU tensor takes stays the library call.

Each wrapper runs its plain version for a CPU tensor and, for a CUDA
tensor, launches its kernel or raises. ``eigh_launches`` and
``svd_launches`` count the wrappers' launches from the host (eager calls,
and the launches a CUDA graph capture records). The kernels inside MAC's
loop run from graphs, whose replays launch them with no host call, some
replays skipping them (a conditional node); so each kernel also counts its
own runs on the device, where every launch adds one to a per-device int64
(:func:`device_launch_counts`, :func:`reset_launches`).
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

MAX_N = 16

#: the wrappers' launches since import (or since :func:`reset_launches`)
eigh_launches = 0
svd_launches = 0
#: per CUDA device index: int64 [2], the kernels' own counts (eigh, svd)
_DEVICE_COUNTS: Dict[int, torch.Tensor] = {}


def _device_counter(dev: torch.device) -> torch.Tensor:
    counts = _DEVICE_COUNTS.get(dev.index)
    if counts is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("small_linalg: the launch counter must exist "
                               "before a CUDA graph capture (an eager call "
                               "makes it)")
        counts = _DEVICE_COUNTS[dev.index] = torch.zeros(
            2, dtype=torch.int64, device=dev)
    return counts


def device_launch_counts(device=None) -> dict:
    """The kernels' runs on ``device`` (default: the current CUDA device)
    as their device counter holds them: a host read."""
    dev = torch.device(device if device is not None else "cuda")
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    counts = _DEVICE_COUNTS.get(index)
    eigh, svd = (0, 0) if counts is None else counts.tolist()
    return {"eigh": eigh, "svd": svd}


def reset_launches() -> None:
    """Set the wrappers' and the devices' counts to 0."""
    global eigh_launches, svd_launches
    eigh_launches = svd_launches = 0
    for counts in _DEVICE_COUNTS.values():
        counts.zero_()


def eigh_descending_ref(A: torch.Tensor):
    """Plain version: ``torch.linalg.eigh``, reversed to descending."""
    w, V = torch.linalg.eigh(A)
    return w.flip(-1), V.flip(-1)


#: the eigh kernel's constants (``csrc/small_eigh.cu``)
MAX_SWEEPS = 40
_OFF_TOL = 1e-26        # squared: off-norm <= 1e-13 |A|_F
_WARP = 32


def _round_robin(N: int) -> list:
    """The kernel's parallel order of ``N`` (even) indices: step ``k``
    pairs ``N - 1`` with ``k`` and ``(k - i) mod (N - 1)`` with ``(k + i)
    mod (N - 1)``; one partner list per step."""
    M = N - 1
    return [[k if j == M else M if j == k else (2 * k - j + M) % M
             for j in range(N)] for k in range(M)]


def _lane_sums(sq: torch.Tensor) -> torch.Tensor:
    """The kernel's sum of ``sq`` (``[b, N, N]``): each lane (row) sums its
    row in column order, then the 32 lanes (zeros past ``N``) add up in
    ``warp_sum``'s butterfly. Returns ``[b]``."""
    acc = torch.zeros(sq.shape[:2], dtype=sq.dtype, device=sq.device)
    for j in range(sq.shape[-1]):
        acc = acc + sq[:, :, j]
    x = torch.nn.functional.pad(acc, (0, _WARP - sq.shape[1]))
    lane = torch.arange(_WARP, device=sq.device)
    for o in (16, 8, 4, 2, 1):
        x = x + x[:, lane ^ o]
    return x[:, 0]


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float64 square root, as the card's ``sqrt``:
    numpy's (the CPU's own instruction); ``torch.sqrt`` on the CPU may
    take a vector math library's, which can miss by one ulp."""
    return torch.from_numpy(np.sqrt(x.numpy()))


def _rotation_tan(app, aqq, apq):
    theta = (aqq - app) / (2.0 * apq)
    sign = torch.where(theta >= 0.0, 1.0, -1.0).to(theta.dtype)
    return torch.where(theta.abs() > 1e150, 0.5 / theta,
                       sign / (theta.abs() + _sqrt(theta * theta + 1.0)))


def _jacobi_step(a, v, partner, n):
    """One parallel step: the rotations of the pairs (r, partner[r])."""
    N = a.shape[-1]
    r = torch.arange(N, device=a.device)
    q = torch.tensor(partner, device=a.device)
    low = r < q
    d = torch.diagonal(a, dim1=1, dim2=2)
    apq = a[:, r, q]
    t = torch.where(low & (q < n) & (apq != 0.0),
                    _rotation_tan(d, d[:, q], apq), torch.zeros_like(d))
    c = 1.0 / _sqrt(t * t + 1.0)
    s = t * c
    lo = torch.minimum(r, q)
    tm, alpha = t[:, lo], c[:, lo]
    beta = torch.where(low, -s[:, lo], s[:, lo])
    ar, br = alpha[:, :, None], beta[:, :, None]
    aj, bj = alpha[:, None, :], beta[:, None, :]
    new = (((ar * aj) * a + (br * bj) * a[:, q][:, :, q])
           + ((ar * bj) * a[:, :, q] + (br * aj) * a[:, q, :]))
    new[:, r, r] = torch.where(low, d - tm * apq, d + tm * apq)
    new[:, r, q] = 0.0
    return new, aj * v + bj * v[:, :, q]


def eigh_jacobi_ref(A: torch.Tensor, max_sweeps: int = MAX_SWEEPS,
                    return_sweeps: bool = False):
    """The eigh kernel's own arithmetic in torch float64, for the tests and
    ``chip_smoke.py`` (never on the main path): the lower triangle read,
    the round-robin order over ``n`` rounded up to even (odd ``n``: a dummy
    index whose pairs rotate by the identity), each entry summed as the
    kernel sums it, the convergence test's sums in the kernel's order, the
    sign rule, and NaN outputs for a non-finite input or no convergence
    within ``max_sweeps``. Its results equal the kernel's bit for bit
    (IEEE float64 with correctly rounded square roots, no fused
    multiply-add on either side). It runs on the CPU and returns on
    ``A``'s device. With ``return_sweeps`` also the sweeps each matrix
    rotated (``[b]`` int64)."""
    a32 = _batched("small eigh", A).cpu()
    b, n = a32.shape[0], a32.shape[-1]
    N = n + n % 2
    dev = a32.device
    lower = torch.ones(n, n, dtype=torch.bool, device=dev).tril()
    sym = torch.where(lower, a32, a32.transpose(1, 2))
    finite = torch.isfinite(sym).flatten(1).all(1)
    a = torch.zeros((b, N, N), dtype=torch.float64, device=dev)
    a[:, :n, :n] = sym.double()
    v = torch.eye(N, dtype=torch.float64, device=dev).expand(b, N, N).clone()
    eye = torch.eye(N, dtype=torch.bool, device=dev)
    fro = _lane_sums(a * a)
    active, converged = finite.clone(), torch.zeros_like(finite)
    sweeps = torch.zeros(b, dtype=torch.int64, device=dev)
    steps = _round_robin(N)
    for _ in range(max_sweeps):
        off = _lane_sums(torch.where(eye, 0.0, a * a))
        done = active & (off <= _OFF_TOL * fro)
        converged |= done
        active &= ~done
        if not bool(active.any()):
            break
        a_new, v_new = a, v
        for partner in steps:
            a_new, v_new = _jacobi_step(a_new, v_new, partner, n)
        keep = active[:, None, None]
        a, v = torch.where(keep, a_new, a), torch.where(keep, v_new, v)
        sweeps += active.to(torch.int64)
    d = torch.diagonal(a, dim1=1, dim2=2)[:, :n]
    order = torch.sort(d, dim=1, descending=True, stable=True).indices
    vv = v[:, :n, :n]
    imax = vv.abs().argmax(dim=1, keepdim=True)
    sign = torch.where(vv.gather(1, imax) < 0.0, -1.0, 1.0).to(vv.dtype)
    w = d.gather(1, order).float()
    V = (sign * vv).gather(2, order[:, None, :].expand(b, n, n)).float()
    w[~converged] = float("nan")
    V[~converged] = float("nan")
    w = w.reshape(A.shape[:-1]).to(A.device)
    V = V.reshape(A.shape).to(A.device)
    return (w, V, sweeps) if return_sweeps else (w, V)


def _row_sums(prod: torch.Tensor) -> torch.Tensor:
    """Each column of ``prod`` (``[b, N, N]``) summed over its rows in row
    order, from zero, as a lane of the SVD kernel sums its column.
    Returns ``[b, N]``."""
    acc = torch.zeros((prod.shape[0], prod.shape[2]), dtype=prod.dtype,
                      device=prod.device)
    for i in range(prod.shape[1]):
        acc = acc + prod[:, i, :]
    return acc


def _svd_step(a, v, partner, n):
    """One parallel step of the one-sided Jacobi SVD: the rotations of the
    column pairs (j, partner[j]). Returns the new ``a``, ``v`` and which
    matrices rotated a pair (``[b]`` bool)."""
    N = a.shape[-1]
    q = torch.tensor(partner, device=a.device)
    low = torch.arange(N, device=a.device) < q
    y, w = a[:, :, q], v[:, :, q]
    sx = _row_sums(a * a)
    gamma = _row_sums(a * y)
    sy = sx[:, q]       # the partner lane's own sum: the same bits
    app, aqq = torch.where(low, sx, sy), torch.where(low, sy, sx)
    rot = ~((gamma.abs() <= (1e-15 * n) * _sqrt(app * aqq))
            | (gamma == 0.0))
    t = _rotation_tan(app, aqq, gamma)
    c = 1.0 / _sqrt(t * t + 1.0)
    s = t * c
    sg = torch.where(low, -s, s)
    c, sg, keep = c[:, None, :], sg[:, None, :], rot[:, None, :]
    return (torch.where(keep, c * a + sg * y, a),
            torch.where(keep, c * v + sg * w, v), rot.any(dim=1))


def _complete_basis(u: torch.Tensor, sigma: list, order: list) -> None:
    """The SVD kernel's completion (``complete_basis``, lane 0 in scalar
    float64): in the sorted ``order``, each column of ``u`` (``[n, n]``
    float64, CPU) whose ``sigma`` is 0 becomes the first unit vector that
    two Gram-Schmidt passes against every earlier column leave with a
    norm above 0.5, normalized. In place."""
    n = u.shape[0]
    m = u.tolist()
    for jj, j in enumerate(order):
        if sigma[j] > 0.0:
            continue
        for e in range(n):
            for i in range(n):
                m[i][j] = 1.0 if i == e else 0.0
            for _ in range(2):
                for k in order[:jj]:
                    d = 0.0
                    for i in range(n):
                        d += m[i][k] * m[i][j]
                    for i in range(n):
                        m[i][j] -= d * m[i][k]
            norm = 0.0
            for i in range(n):
                norm += m[i][j] * m[i][j]
            norm = math.sqrt(norm)
            if norm > 0.5:
                for i in range(n):
                    m[i][j] /= norm
                break
    u.copy_(torch.tensor(m, dtype=u.dtype))


def svd_jacobi_ref(A: torch.Tensor, max_sweeps: int = MAX_SWEEPS,
                   return_sweeps: bool = False):
    """The SVD kernel's own arithmetic in torch float64, for the tests and
    ``chip_smoke.py`` (never on the main path): one-sided Jacobi over the
    columns in the round-robin order over ``n`` rounded up to even (odd
    ``n``: a zero dummy column, never rotated), each pair's norms and dot
    product summed in row order, the skip test ``|gamma| <= 1e-15 n
    sqrt(alpha beta)`` and the stop at a sweep with no rotation, the
    singular values as the columns' norms, sorted descending (ties by
    ascending index), the sign rule, the completion of a zero singular
    value's left vector, and NaN outputs for a non-finite input or no
    convergence within ``max_sweeps``. Its results equal the kernel's bit
    for bit (IEEE float64 with correctly rounded square roots and
    divisions, no fused multiply-add on either side). It runs on the CPU
    and returns on ``A``'s device. With ``return_sweeps`` also the sweeps
    each matrix ran, its last (rotation-free) one included (``[b]``
    int64)."""
    a32 = _batched("small svd", A).cpu()
    b, n = a32.shape[0], a32.shape[-1]
    N = n + n % 2
    finite = torch.isfinite(a32).flatten(1).all(1)
    a = torch.zeros((b, N, N), dtype=torch.float64)
    a[:, :n, :n] = torch.where(finite[:, None, None], a32, 0.0).double()
    v = torch.eye(N, dtype=torch.float64).expand(b, N, N).clone()
    active, converged = finite.clone(), torch.zeros_like(finite)
    sweeps = torch.zeros(b, dtype=torch.int64)
    steps = _round_robin(N)
    for _ in range(max_sweeps):
        if not bool(active.any()):
            break
        rotated = torch.zeros_like(active)
        a_new, v_new = a, v
        for partner in steps:
            a_new, v_new, rot = _svd_step(a_new, v_new, partner, n)
            rotated |= rot
        keep = active[:, None, None]
        a, v = torch.where(keep, a_new, a), torch.where(keep, v_new, v)
        sweeps += active.to(torch.int64)
        converged |= active & ~rotated
        active &= rotated
    sigma = _sqrt(_row_sums(a * a))[:, :n]
    order = torch.sort(sigma, dim=1, descending=True, stable=True).indices
    an = a[:, :n, :n]
    u = torch.where(sigma[:, None, :] > 0.0, an / sigma[:, None, :], 0.0)
    for m in (converged & (sigma == 0.0).any(dim=1)).nonzero()[:, 0].tolist():
        _complete_basis(u[m], sigma[m].tolist(), order[m].tolist())
    vv = v[:, :n, :n]
    imax = vv.abs().argmax(dim=1, keepdim=True)
    sign = torch.where(vv.gather(1, imax) < 0.0, -1.0, 1.0).to(vv.dtype)
    cols = order[:, None, :].expand(b, n, n)
    S = sigma.gather(1, order).float()
    U = (sign * u).gather(2, cols).float()
    Vh = (sign * vv).gather(2, cols).transpose(1, 2).float()
    for out in (U, S, Vh):
        out[~converged] = float("nan")
    U, Vh = (x.reshape(A.shape).to(A.device) for x in (U, Vh))
    S = S.reshape(A.shape[:-1]).to(A.device)
    return (U, S, Vh, sweeps) if return_sweeps else (U, S, Vh)


def svd_ref(A: torch.Tensor):
    """Plain version: ``torch.linalg.svd``."""
    return torch.linalg.svd(A)


def _batched(what: str, A: torch.Tensor) -> torch.Tensor:
    if A.dtype != torch.float32:
        raise TypeError(f"{what} takes float32 matrices, not {A.dtype}")
    if A.dim() < 2 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"{what} takes square matrices, not "
                         f"{tuple(A.shape)}")
    if not 1 <= A.shape[-1] <= MAX_N:
        raise ValueError(f"{what} takes 1 <= n <= {MAX_N}, not "
                         f"{A.shape[-1]}")
    return A.reshape(-1, A.shape[-1], A.shape[-1]).contiguous()


def _call(fn_name: str, dev, slot: int, *args) -> None:
    from cslam_tpu_torch.ops.nns import _lib_fn
    with torch.cuda.device(dev):
        count = _device_counter(dev)[slot:]
        rc = _lib_fn("small_eigh", fn_name)(
            *args, count.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} launch failed: cudaError {rc}")


def _eigh_cuda(A: torch.Tensor):
    global eigh_launches
    a = _batched("small eigh", A)
    b, n = a.shape[0], a.shape[-1]
    w = torch.empty((b, n), dtype=torch.float32, device=a.device)
    V = torch.empty((b, n, n), dtype=torch.float32, device=a.device)
    if b:
        _call("cslam_small_eigh", a.device, 0, a.data_ptr(), w.data_ptr(),
              V.data_ptr(), b, n)
        eigh_launches += 1
    return w.reshape(A.shape[:-1]), V.reshape(A.shape)


def _svd_cuda(A: torch.Tensor):
    global svd_launches
    a = _batched("small svd", A)
    b, n = a.shape[0], a.shape[-1]
    U = torch.empty((b, n, n), dtype=torch.float32, device=a.device)
    S = torch.empty((b, n), dtype=torch.float32, device=a.device)
    Vh = torch.empty((b, n, n), dtype=torch.float32, device=a.device)
    if b:
        _call("cslam_small_svd", a.device, 1, a.data_ptr(), U.data_ptr(),
              S.data_ptr(), Vh.data_ptr(), b, n)
        svd_launches += 1
    return U.reshape(A.shape), S.reshape(A.shape[:-1]), Vh.reshape(A.shape)


def eigh_descending(A: torch.Tensor):
    """Eigenvalues (descending) and eigenvectors (columns) of symmetric
    ``[..., n, n]`` float32 matrices, ``n <= MAX_N`` (see the module
    note). CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    if A.device.type == "cpu":
        return eigh_descending_ref(A)
    if A.device.type != "cuda":
        raise ValueError(f"no small eigh for device {A.device}")
    return _eigh_cuda(A)


def svd(A: torch.Tensor):
    """``(U, S, Vh)`` of square ``[..., n, n]`` float32 matrices, ``n <=
    MAX_N``, ``S`` descending (see the module note). CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    if A.device.type == "cpu":
        return svd_ref(A)
    if A.device.type != "cuda":
        raise ValueError(f"no small svd for device {A.device}")
    return _svd_cuda(A)
