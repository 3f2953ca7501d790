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

from typing import Dict

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
