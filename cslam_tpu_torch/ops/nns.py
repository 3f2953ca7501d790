"""Exact cosine top-k bank scan: the hand-written CUDA kernel K1 and its
plain PyTorch version.

Replaces the TPU kernel ``cslam_tpu/ops/nns_pallas.py::_scan_kernel2``
(launched by ``_fused2_pre_one`` behind ``cosine_topk_fused2_pre``). The
contract is the same:

- the exact top-k (``k <= MAX_K``) of ``q . b`` over the first ``n`` rows of
  a bank of UNIT rows (taken as given, never re-normalized here), ordered by
  value descending and then row index ascending (the ``lax.top_k`` rule);
- f32 or bf16 bank; with a bf16 bank the queries are rounded to bf16 and
  the products are summed in f32;
- the output scaled by ``1/max(||q||, 1e-12)`` of the f32 queries BEFORE
  any bf16 rounding;
- with ``n < k`` the trailing slots hold ``-inf`` with the lowest invalid
  indices ``n, n+1, ...`` (what ``lax.top_k`` gives over the masked bank).

The TPU artefacts stay behind: no tile multiples, no 512-row batch chunking,
no dropped-value bound and no whole-batch fallback. Any B, any N and any
``n <= N`` work. The kernel's design and what bounds it on the card are in
the note at the top of ``csrc/bank_scan.cu``.

:func:`cosine_topk_scan` is the wrapper: for a CPU tensor it runs
:func:`cosine_topk_scan_ref`; for a CUDA tensor it launches the kernel or
raises. ``launches`` counts kernel launches (and nothing else), so a run can
show that its searches went through the kernel.

The kernel is built from ``csrc/bank_scan.cu`` with ``nvcc`` for ``sm_90a``
at first use, into ``csrc/build/`` (keyed by the source's hash), and loaded
with ``ctypes``.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

from cslam_tpu_torch.ops.topk import topk_ties_ascending

MAX_K = 128       # largest k the kernel takes
MAX_DIM = 128     # largest descriptor width the kernel's shared memory takes
_ROWS_PER_TILE = 256
_QUERIES_PER_BLOCK = 32
_MAX_SPLITS = 32  # the merge kernel gives one split to each lane of a warp
_EPS = 1e-12

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCE = _CSRC / "bank_scan.cu"
BUILD_DIR = _CSRC / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

#: kernel launches since import (or since the caller last reset it)
launches = 0

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the bank-scan kernel is built "
                           "from csrc/bank_scan.cu at first use on the card")
    return path


def build() -> Path:
    """Compile ``csrc/bank_scan.cu`` (once per source version) and return
    the shared library's path. ``nvcc -Xptxas -v`` output (registers,
    shared memory, spills) is kept beside it as ``*.ptxas.txt``."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"libbank_scan_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: concurrent first users
    # never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed to build {SOURCE.name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    (BUILD_DIR / f"bank_scan_{tag}.ptxas.txt").write_text(
        proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.cslam_bank_scan.argtypes = [vp, ci, ci, ci, vp, ci, ci, ci,
                                            ci, vp, vp, vp, vp, vp]
            lib.cslam_bank_scan.restype = ci
            _lib = lib
    return _lib


def _scale(vals: torch.Tensor, q_f32: torch.Tensor) -> torch.Tensor:
    q_inv = 1.0 / torch.clamp(torch.linalg.vector_norm(q_f32, dim=-1),
                              min=_EPS)
    return vals * q_inv[:, None]


def _kernel_queries(bank: torch.Tensor, q_f32: torch.Tensor) -> torch.Tensor:
    """Queries as the scan sees them: bf16-rounded for a bf16 bank."""
    if bank.dtype == torch.bfloat16:
        return q_f32.to(torch.bfloat16).float()
    return q_f32


def _pad(vals, idx, n: int, k: int):
    """Fill slots past the ``n`` valid rows with (-inf, n, n+1, ...)."""
    if n >= k:
        return vals, idx
    B = vals.shape[0]
    pad_v = torch.full((B, k - n), -float("inf"), dtype=vals.dtype,
                       device=vals.device)
    pad_i = torch.arange(n, k, device=idx.device).expand(B, k - n)
    return torch.cat([vals, pad_v], 1), torch.cat([idx, pad_i], 1)


def cosine_topk_scan_ref(bank: torch.Tensor, n: int, queries: torch.Tensor,
                         k: int):
    """Plain PyTorch version of the kernel, same contract, same numbers.

    The dot products are summed over ``d = 0..D-1`` from zero with one
    elementwise multiply and one elementwise add per step, each rounded to
    float32 — the kernel's own order and roundings — so the two agree bit
    for bit, ties included. Returns ``(values [B, k] f32, indices [B, k]
    int64)``.
    """
    n = int(n)
    q_f32 = queries.float()
    q = _kernel_queries(bank, q_f32)
    rows = bank[:n].float()
    sims = torch.zeros((q.shape[0], n), dtype=torch.float32,
                       device=bank.device)
    for d in range(bank.shape[1]):
        sims += q[:, d:d + 1] * rows[:, d]
    vals, idx = topk_ties_ascending(sims, min(k, n))
    vals, idx = _pad(vals, idx, n, k)
    return _scale(vals, q_f32), idx


def _splits(n: int, num_query_blocks: int, device: torch.device):
    """(split_rows, S): enough (split x query block) blocks to fill every
    SM twice, each split a whole number of tiles."""
    tiles = max(1, math.ceil(n / _ROWS_PER_TILE))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    S = min(_MAX_SPLITS, tiles,
            max(1, math.ceil(2 * sms / num_query_blocks)))
    split_rows = math.ceil(tiles / S) * _ROWS_PER_TILE
    return split_rows, max(1, math.ceil(n / split_rows))


def _cosine_topk_scan_cuda(bank: torch.Tensor, n: int,
                           queries: torch.Tensor, k: int):
    global launches
    if bank.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"bank scan takes f32 or bf16 banks, not {bank.dtype}")
    if bank.dim() != 2 or not bank.is_contiguous():
        raise ValueError("bank scan needs a contiguous [N, D] bank")
    if queries.dim() != 2 or queries.shape[1] != bank.shape[1]:
        raise ValueError(f"queries {tuple(queries.shape)} do not match the "
                         f"bank's width {bank.shape[1]}")
    if queries.device != bank.device:
        raise ValueError("queries and bank lie on different devices")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"bank scan takes 1 <= k <= {MAX_K}, not {k}")
    D = bank.shape[1]
    if D > MAX_DIM:
        raise ValueError(f"bank scan takes D <= {MAX_DIM}, not {D}")
    n = max(0, min(int(n), bank.shape[0]))
    B = queries.shape[0]
    q_f32 = queries.float()
    if B == 0:
        return (torch.empty((0, k), device=bank.device),
                torch.empty((0, k), dtype=torch.int64, device=bank.device))
    q = _kernel_queries(bank, q_f32).contiguous()
    split_rows, S = _splits(n, math.ceil(B / _QUERIES_PER_BLOCK),
                            bank.device)
    dev = bank.device
    part_v = torch.empty((S, B, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((S, B, k), dtype=torch.int32, device=dev)
    out_v = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.cslam_bank_scan(
            bank.data_ptr(), int(bank.dtype == torch.bfloat16), n, D,
            q.data_ptr(), B, k, split_rows, S, part_v.data_ptr(),
            part_i.data_ptr(), out_v.data_ptr(), out_i.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"bank_scan launch failed: cudaError {rc}")
    launches += 1
    return _scale(out_v, q_f32), out_i.long()


def cosine_topk_scan(bank: torch.Tensor, n: int, queries: torch.Tensor,
                     k: int):
    """Exact cosine top-k over a bank of UNIT rows (the K1 contract; see the
    module docstring). CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    if bank.device.type == "cpu":
        return cosine_topk_scan_ref(bank, n, queries, k)
    if bank.device.type != "cuda":
        raise ValueError(f"no bank scan for device {bank.device}")
    return _cosine_topk_scan_cuda(bank, n, queries, k)
