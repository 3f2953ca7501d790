"""Exact cosine top-k bank scans: the hand-written CUDA kernels K1 and K2 and
their plain PyTorch versions.

**K1**, :func:`cosine_topk_scan` (``csrc/bank_scan.cu``), replaces the TPU
kernel ``cslam_tpu/ops/nns_pallas.py::_scan_kernel2`` (launched by
``_fused2_pre_one`` behind ``cosine_topk_fused2_pre``). The contract is the
same:

- the exact top-k (``k <= MAX_K``) of ``q . b`` over the first ``n`` rows of
  a bank of UNIT rows (taken as given, never re-normalized here), ordered by
  value descending and then row index ascending (the ``lax.top_k`` rule);
- f32 or bf16 bank; with a bf16 bank the queries are rounded to bf16 and
  the products are summed in f32;
- the output scaled by ``1/max(||q||, 1e-12)`` of the f32 queries BEFORE
  any bf16 rounding;
- with ``n < k`` the trailing slots hold ``-inf`` with the lowest invalid
  indices ``n, n+1, ...`` (what ``lax.top_k`` gives over the masked bank).

**K2**, :func:`cosine_topk_fused` (``csrc/tile_scan.cu``), replaces the TPU
kernel ``cslam_tpu/ops/nns_pallas.py::_scan_kernel`` (launched by
``cosine_topk_fused``), the drop-in equivalent of ``ops.topk.cosine_topk``
for ``k <= KERNEL_K``:

- the exact top-k of ``(q . b) * inv_norms[r]`` over the first ``n`` rows of
  a NON-unit bank, ordered as above, scaled by ``1/max(||q||, 1e-12)``;
- a bf16 bank is widened to f32; the queries are NOT rounded;
- with ``n < k`` the trailing slots hold ``(-inf, 0)``, repeated: the TPU
  kernel's argmax over an all ``-inf`` tile returns its first column.

The TPU artefacts stay behind: no tile multiples, no 512-row batch chunking,
no dropped-value bound and no whole-batch fallback. Any B, any N and any
``n <= N`` work. Each kernel's design and what bounds it on the card are in
the note at the top of its source.

Each wrapper runs its plain version (``*_ref``) for a CPU tensor, and for a
CUDA tensor launches its kernel or raises. ``launches`` counts K1's kernel
launches and ``tile_scan_launches`` K2's (and nothing else), so a run can
show that its searches went through the kernels.

The kernels are built from ``csrc/*.cu`` (with the device code they share,
``csrc/scan_tile.cuh``) with ``nvcc`` for ``sm_90a`` at first use
(:func:`build` compiles all of them at once, one ``nvcc`` each), into
``csrc/build/`` (keyed by the sources' hash), and loaded with ``ctypes``.
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
from typing import Dict, Iterable, Optional

import torch

from cslam_tpu_torch.ops.topk import topk_ties_ascending

MAX_K = 128       # largest k K1 takes
KERNEL_K = 10     # largest k K2 takes (the TPU kernel's per-tile candidates)
MAX_DIM = 128     # largest descriptor width the kernels' shared memory takes
_ROWS_PER_TILE = 256
_QUERIES_PER_BLOCK = 32
_MAX_SPLITS = 32  # K1's merge kernel gives one split to each lane of a warp
_TILE_SCAN_MAX_SPLITS = 256  # bounds K2's merge walk (S * k entries a warp)
_EPS = 1e-12

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = {"bank_scan": _CSRC / "bank_scan.cu",
           "tile_scan": _CSRC / "tile_scan.cu"}
BUILD_DIR = _CSRC / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_vp, _ci = ctypes.c_void_p, ctypes.c_int
#: each library's C entry point and its argument types
_ENTRY = {
    "bank_scan": ("cslam_bank_scan", [_vp, _ci, _ci, _ci, _vp, _ci, _ci, _ci,
                                      _ci, _vp, _vp, _vp, _vp, _vp]),
    "tile_scan": ("cslam_tile_scan", [_vp, _ci, _vp, _ci, _ci, _vp, _ci, _ci,
                                      _ci, _ci, _vp, _vp, _vp, _vp, _vp]),
}

#: K1 kernel launches since import (or since the caller last reset it)
launches = 0
#: K2 kernel launches since import (or since the caller last reset it)
tile_scan_launches = 0

_libs: Dict[str, ctypes.CDLL] = {}
_lib_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the bank-scan kernels are built "
                           "from csrc/*.cu at first use on the card")
    return path


def _target(name: str):
    src = SOURCES[name].read_bytes() + b"".join(
        p.read_bytes() for p in sorted(_CSRC.glob("*.cuh")))
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{tag}.so", tag


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the kernels' sources (all by default; each once per source
    version), one ``nvcc`` per source, all started together, and return
    ``{name: shared library path}``. ``nvcc -Xptxas -v`` output (registers,
    shared memory, spills) is kept beside each as ``*.ptxas.txt``."""
    names = list(SOURCES) if names is None else list(names)
    libs = {name: _target(name) for name in names}
    todo = {name: t for name, t in libs.items() if not t[0].exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
    procs = {}
    for name, (out, tag) in todo.items():
        # build under a private name, then rename: concurrent first users
        # never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, str(SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    errors = []
    for name, (tmp, proc) in procs.items():
        log = proc.communicate()[0]
        out, tag = libs[name]
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed to build {SOURCES[name].name}:\n{log}")
            continue
        (BUILD_DIR / f"{name}_{tag}.ptxas.txt").write_text(log)
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: out for name, (out, _) in libs.items()}


def _load(name: str) -> ctypes.CDLL:
    with _lib_lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build([name])[name]))
            fn_name, argtypes = _ENTRY[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = _ci
            _libs[name] = lib
    return _libs[name]


def _scale(vals: torch.Tensor, q_f32: torch.Tensor) -> torch.Tensor:
    q_inv = 1.0 / torch.clamp(torch.linalg.vector_norm(q_f32, dim=-1),
                              min=_EPS)
    return vals * q_inv[:, None]


def _kernel_queries(bank: torch.Tensor, q_f32: torch.Tensor) -> torch.Tensor:
    """Queries as K1 sees them: bf16-rounded for a bf16 bank."""
    if bank.dtype == torch.bfloat16:
        return q_f32.to(torch.bfloat16).float()
    return q_f32


def _dots(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``q @ rows.T`` summed over ``d = 0..D-1`` from zero with one
    elementwise multiply and one elementwise add per step, each rounded to
    float32: the kernels' own order and roundings."""
    sims = torch.zeros((q.shape[0], rows.shape[0]), dtype=torch.float32,
                       device=rows.device)
    for d in range(rows.shape[1]):
        sims += q[:, d:d + 1] * rows[:, d]
    return sims


def _pad(vals, idx, n: int, k: int, tail_zero: bool = False):
    """Fill slots past the ``n`` valid rows with ``-inf`` and the indices
    ``n, n+1, ...`` (K1), or ``0, 0, ...`` with ``tail_zero`` (K2)."""
    if n >= k:
        return vals, idx
    B = vals.shape[0]
    pad_v = torch.full((B, k - n), -float("inf"), dtype=vals.dtype,
                       device=vals.device)
    if tail_zero:
        pad_i = torch.zeros((B, k - n), dtype=idx.dtype, device=idx.device)
    else:
        pad_i = torch.arange(n, k, device=idx.device).expand(B, k - n)
    return torch.cat([vals, pad_v], 1), torch.cat([idx, pad_i], 1)


def cosine_topk_scan_ref(bank: torch.Tensor, n: int, queries: torch.Tensor,
                         k: int):
    """Plain PyTorch version of K1, same contract, same numbers.

    The dot products are summed in the kernel's own order and roundings
    (:func:`_dots`), so the two agree bit for bit, ties included. Returns
    ``(values [B, k] f32, indices [B, k] int64)``.
    """
    n = int(n)
    q_f32 = queries.float()
    sims = _dots(_kernel_queries(bank, q_f32), bank[:n].float())
    vals, idx = topk_ties_ascending(sims, min(k, n))
    vals, idx = _pad(vals, idx, n, k)
    return _scale(vals, q_f32), idx


def cosine_topk_fused_ref(bank: torch.Tensor, inv_norms: torch.Tensor,
                          n: int, queries: torch.Tensor, k: int):
    """Plain PyTorch version of K2, same contract, same numbers.

    Each dot product is summed as K1's (:func:`_dots`), then multiplied by
    its row's ``inv_norms`` (one rounding), so kernel and plain version
    agree bit for bit, ties included. Returns ``(values [B, k] f32,
    indices [B, k] int64)``.
    """
    n = max(0, min(int(n), bank.shape[0]))
    q_f32 = queries.float()
    sims = _dots(q_f32, bank[:n].float()) * inv_norms[:n].float()
    vals, idx = topk_ties_ascending(sims, min(k, n))
    vals, idx = _pad(vals, idx, n, k, tail_zero=True)
    return _scale(vals, q_f32), idx


def _splits(n: int, num_query_blocks: int, device: torch.device,
            max_splits: int = _MAX_SPLITS):
    """(split_rows, S): enough (split x query block) blocks to fill every
    SM twice, each split a whole number of tiles."""
    tiles = max(1, math.ceil(n / _ROWS_PER_TILE))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    S = min(max_splits, tiles,
            max(1, math.ceil(2 * sms / num_query_blocks)))
    split_rows = math.ceil(tiles / S) * _ROWS_PER_TILE
    return split_rows, max(1, math.ceil(n / split_rows))


def _check_scan_args(what: str, bank: torch.Tensor, queries: torch.Tensor,
                     k: int, max_k: int) -> None:
    """Raise on what a bank-scan kernel does not take."""
    if bank.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what} takes f32 or bf16 banks, not {bank.dtype}")
    if bank.dim() != 2 or not bank.is_contiguous():
        raise ValueError(f"{what} needs a contiguous [N, D] bank")
    if queries.dim() != 2 or queries.shape[1] != bank.shape[1]:
        raise ValueError(f"queries {tuple(queries.shape)} do not match the "
                         f"bank's width {bank.shape[1]}")
    if queries.device != bank.device:
        raise ValueError("queries and bank lie on different devices")
    if not 1 <= k <= max_k:
        raise ValueError(f"{what} takes 1 <= k <= {max_k}, not {k}")
    if bank.shape[1] > MAX_DIM:
        raise ValueError(f"{what} takes D <= {MAX_DIM}, not {bank.shape[1]}")


def _outputs(S: int, B: int, k: int, dev: torch.device):
    """Per-split scratch and the outputs of one launch."""
    return (torch.empty((S, B, k), dtype=torch.float32, device=dev),
            torch.empty((S, B, k), dtype=torch.int32, device=dev),
            torch.empty((B, k), dtype=torch.float32, device=dev),
            torch.empty((B, k), dtype=torch.int32, device=dev))


def _empty(k: int, dev: torch.device):
    return (torch.empty((0, k), device=dev),
            torch.empty((0, k), dtype=torch.int64, device=dev))


def _cosine_topk_scan_cuda(bank: torch.Tensor, n: int,
                           queries: torch.Tensor, k: int):
    global launches
    _check_scan_args("bank scan", bank, queries, k, MAX_K)
    D = bank.shape[1]
    n = max(0, min(int(n), bank.shape[0]))
    B = queries.shape[0]
    q_f32 = queries.float()
    if B == 0:
        return _empty(k, bank.device)
    q = _kernel_queries(bank, q_f32).contiguous()
    split_rows, S = _splits(n, math.ceil(B / _QUERIES_PER_BLOCK),
                            bank.device)
    dev = bank.device
    part_v, part_i, out_v, out_i = _outputs(S, B, k, dev)
    lib = _load("bank_scan")
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


def _cosine_topk_fused_cuda(bank: torch.Tensor, inv_norms: torch.Tensor,
                            n: int, queries: torch.Tensor, k: int):
    global tile_scan_launches
    _check_scan_args("tile scan", bank, queries, k, KERNEL_K)
    if inv_norms.shape != (bank.shape[0],) or inv_norms.device != bank.device:
        raise ValueError(f"inv_norms {tuple(inv_norms.shape)} on "
                         f"{inv_norms.device} do not match the bank "
                         f"{tuple(bank.shape)} on {bank.device}")
    D = bank.shape[1]
    n = max(0, min(int(n), bank.shape[0]))
    B = queries.shape[0]
    dev = bank.device
    if B == 0:
        return _empty(k, dev)
    q = queries.float().contiguous()
    inv = inv_norms.float().contiguous()
    split_rows, S = _splits(n, math.ceil(B / _QUERIES_PER_BLOCK), dev,
                            _TILE_SCAN_MAX_SPLITS)
    part_v, part_i, out_v, out_i = _outputs(S, B, k, dev)
    lib = _load("tile_scan")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.cslam_tile_scan(
            bank.data_ptr(), int(bank.dtype == torch.bfloat16),
            inv.data_ptr(), n, D, q.data_ptr(), B, k, split_rows, S,
            part_v.data_ptr(), part_i.data_ptr(), out_v.data_ptr(),
            out_i.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"tile_scan launch failed: cudaError {rc}")
    tile_scan_launches += 1
    return _scale(out_v, q), out_i.long()


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


def cosine_topk_fused(bank: torch.Tensor, inv_norms: torch.Tensor, n: int,
                      queries: torch.Tensor, k: int):
    """Exact cosine top-k (``k <= KERNEL_K``) over a bank with inverse row
    norms (the K2 contract; see the module docstring), the drop-in
    equivalent of ``ops.topk.cosine_topk``. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if not 1 <= k <= KERNEL_K:
        raise ValueError(f"tile scan takes 1 <= k <= {KERNEL_K}, not {k}")
    if bank.device.type == "cpu":
        return cosine_topk_fused_ref(bank, inv_norms, n, queries, k)
    if bank.device.type != "cuda":
        raise ValueError(f"no tile scan for device {bank.device}")
    return _cosine_topk_fused_cuda(bank, inv_norms, n, queries, k)
