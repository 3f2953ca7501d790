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
``n <= N`` work. Both kernels take two paths, chosen by the batch size alone:
a tensor-core screen with an exact FP32 rescore for ``B >= SCREEN_MIN_B``,
exact dots one row per thread below it (``csrc/scan_tile.cuh`` holds both,
the screen's error bound and why the result is exact; :func:`screen_ref`
emulates the screen for the tests). The query norm of the final scaling is
summed in the plain order too (:func:`_q_scale`), so the kernels' fused
epilogue and the plain versions agree bit for bit. Each kernel's design and
what bounds it on the card are in the note at the top of its source.

Each wrapper runs its plain version (``*_ref``) for a CPU tensor, and for a
CUDA tensor launches its kernel or raises; on the card each call is two CUDA
kernels (scan and merge) writing straight into the f32 / int64 outputs.
The bank, the queries and ``inv_norms`` must be 16-byte aligned (the tiles
arrive by 16-byte ``cp.async``); the wrapper raises otherwise and never
copies. ``launches`` counts K1's wrapper launches and ``tile_scan_launches``
K2's (and nothing else), so a run can show that its searches went through
the kernels.

The kernels are built from ``csrc/*.cu`` (with the device code they share,
``csrc/scan_tile.cuh``) with ``nvcc`` for ``sm_90a`` at first use
(:func:`build` compiles all of them at once, one ``nvcc`` each), into
``csrc/build/`` (keyed by the sources' hash), and loaded with ``ctypes``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
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
SCREEN_MIN_B = 16  # batches from this size take the tensor-core screen
#: the screen's error bound eps / (||q|| ||b_r|| |inv_r|), by the MMA's input
#: rounding (``csrc/scan_tile.cuh`` derives them): TF32 for an f32 bank; bf16
#: for a bf16 bank with K1's (already bf16) queries; bf16 for a bf16 bank
#: with K2's f32 queries, rounded to bf16 in the MMA operand
SCREEN_EPS = {"tf32": 2.0 ** -7, "bf16": 2.0 ** -10,
              "bf16_rounded_queries": 2.0 ** -6}
_EPS = 1e-12

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = {"bank_scan": _CSRC / "bank_scan.cu",
           "tile_scan": _CSRC / "tile_scan.cu",
           # LOBPCG's small eigensolves (``ops/small_linalg.py``)
           "small_eigh": _CSRC / "small_eigh.cu",
           # while loops of CUDA graphs (``utils/tier_graphs.py``)
           "graph_while": _CSRC / "graph_while.cu",
           # fixed-order sums of the solvers (``ops/segment_sum.py``)
           "segment_sum": _CSRC / "segment_sum.cu"}
BUILD_DIR = _CSRC / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_vp, _ci, _cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: each library's C entry points and their argument types
_ENTRY = {
    "bank_scan": {
        "cslam_bank_scan": [_vp, _ci, _ci, _ci, _vp, _ci, _ci, _ci, _vp, _vp,
                            _vp, _vp, _vp, _vp],
        "cslam_bank_scan_splits": [_ci, _ci, _ci, _ci, _ci]},
    "tile_scan": {
        "cslam_tile_scan": [_vp, _ci, _vp, _ci, _ci, _vp, _ci, _ci, _ci, _vp,
                            _vp, _vp, _vp, _vp, _vp],
        "cslam_tile_scan_splits": [_ci, _ci, _ci, _ci, _ci]},
    "small_eigh": {
        "cslam_small_eigh": [_vp, _vp, _vp, _ci, _ci, _vp, _vp],
        "cslam_small_svd": [_vp, _vp, _vp, _vp, _ci, _ci, _vp, _vp]},
    "graph_while": {
        "cslam_plan_create": [_vp, _vp, _ci, _vp],
        "cslam_while_launch": [_vp, _vp]},
    "segment_sum": {
        "cslam_segment_sum": [_vp, _vp, _vp, _vp, _cll, _ci, _vp, _vp]},
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
        raise RuntimeError("nvcc not found: the kernels are built from "
                           "csrc/*.cu at first use on the card")
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
            for fn_name, argtypes in _ENTRY[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = _ci
            _libs[name] = lib
    return _libs[name]


def _q_scale(q_f32: torch.Tensor) -> torch.Tensor:
    """``1/max(||q||, 1e-12)`` per query, ``||q||^2`` summed over ``d =
    0..D-1`` from zero with each square and each sum rounded to float32 (the
    kernels' merge computes it the same way; ``torch.linalg.vector_norm``
    leaves its reduction order to the device), then a correctly rounded
    square root and reciprocal."""
    ss = torch.zeros(q_f32.shape[0], dtype=torch.float32,
                     device=q_f32.device)
    for d in range(q_f32.shape[1]):
        ss = ss + q_f32[:, d] * q_f32[:, d]
    return 1.0 / torch.clamp(torch.sqrt(ss), min=_EPS)


def _scale(vals: torch.Tensor, q_f32: torch.Tensor) -> torch.Tensor:
    return vals * _q_scale(q_f32)[:, None]


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


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10-bit mantissa, to nearest, ties away from
    zero: ``cvt.rna.tf32.f32``)."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64)
    bits = ((bits & 0xFFFFFFFF) + 0x1000) & 0xFFFFE000
    return (bits - ((bits & 0x80000000) << 1)).to(torch.int32).view(
        torch.float32)


def screen_ref(bank: torch.Tensor, n: int, queries: torch.Tensor,
               inv_norms: Optional[torch.Tensor] = None):
    """The kernels' tensor-core screen, emulated (used only by the tests):
    returns ``(s_tilde, eps)``, both float64 ``[B, n]``.

    ``s_tilde`` sums the products of the MMA's rounded inputs in float64:
    TF32 for an f32 bank; bf16 for a bf16 bank, with K1's queries (already
    bf16-rounded) or K2's f32 queries rounded to bf16. ``eps`` is the
    kernel's bound ``c ||q|| ||b_r||`` (K2, given ``inv_norms``: both times
    ``inv_norms[r]``, the bound times ``|inv_norms[r]|``), with ``||q||`` of
    the queries the kernel holds. A row survives the screen for query q
    while ``s_tilde + eps >= tau_q``."""
    n = max(0, min(int(n), bank.shape[0]))
    rows = bank[:n].float()
    q = queries.float()
    if inv_norms is None:
        q = _kernel_queries(bank, q)
    if bank.dtype == torch.bfloat16:
        q_mma, rows_mma = q.to(torch.bfloat16).float(), rows
        c = SCREEN_EPS["bf16" if inv_norms is None
                       else "bf16_rounded_queries"]
    else:
        q_mma, rows_mma = _tf32(q), _tf32(rows)
        c = SCREEN_EPS["tf32"]
    s_tilde = q_mma.double() @ rows_mma.double().T
    eps = c * (torch.linalg.vector_norm(q.double(), dim=1)[:, None]
               * torch.linalg.vector_norm(rows.double(), dim=1)[None, :])
    if inv_norms is not None:
        inv = inv_norms[:n].double()
        s_tilde, eps = s_tilde * inv, eps * inv.abs()
    return s_tilde, eps


@functools.lru_cache(maxsize=None)
def _lib_fn(name: str, fn_name: str):
    return getattr(_load(name), fn_name)


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


def _check_aligned(what: str, **tensors: torch.Tensor) -> None:
    """The kernels load by 16-byte ``cp.async``: raise on a pointer that is
    not 16-byte aligned (never copy behind the caller's back)."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned "
                             f"(data_ptr {t.data_ptr():#x})")


def _launch(name: str, B: int, k: int, D: int, n: int, bank: torch.Tensor,
            args_before_queries, q: torch.Tensor, stats):
    """Both kernels' launch: the splits S for this shape, the [B, S, k]
    scratch, the f32 / int64 outputs, one C call (scan + merge)."""
    dev = bank.device
    bf16 = int(bank.dtype == torch.bfloat16)
    with torch.cuda.device(dev):
        S = _lib_fn(name, f"cslam_{name}_splits")(bf16, n, D, B, k)
        if S < 1:
            raise RuntimeError(f"{name}: no launch shape for B={B}, k={k}, "
                               f"D={D}")
        part_v = torch.empty((B, S, k), dtype=torch.float32, device=dev)
        part_i = torch.empty((B, S, k), dtype=torch.int32, device=dev)
        out_v = torch.empty((B, k), dtype=torch.float32, device=dev)
        out_i = torch.empty((B, k), dtype=torch.int64, device=dev)
        rc = _lib_fn(name, f"cslam_{name}")(
            bank.data_ptr(), bf16, *args_before_queries, q.data_ptr(), B, k,
            S, part_v.data_ptr(), part_i.data_ptr(), out_v.data_ptr(),
            out_i.data_ptr(), None if stats is None else stats.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    return out_v, out_i


def _check_stats(stats) -> None:
    """``stats``: None, or a zeroed int32 CUDA tensor of 8 that the kernel
    fills (``scan::Stats``): [0] the filter's survivors, [1] the screen's
    largest observed error over ||q|| ||b|| (f32 bits), [2:8] three int64
    sums of SM cycles by phase (see ``csrc/scan_tile.cuh``). For
    measurement only; it changes no result."""
    if stats is not None and not (stats.dtype == torch.int32
                                  and stats.is_cuda and stats.numel() == 8
                                  and stats.is_contiguous()):
        raise ValueError("stats is a contiguous int32 CUDA tensor of 8")


def _empty(k: int, dev: torch.device):
    return (torch.empty((0, k), device=dev),
            torch.empty((0, k), dtype=torch.int64, device=dev))


def _cosine_topk_scan_cuda(bank: torch.Tensor, n: int,
                           queries: torch.Tensor, k: int, stats=None):
    global launches
    _check_scan_args("bank scan", bank, queries, k, MAX_K)
    _check_stats(stats)
    D = bank.shape[1]
    n = max(0, min(int(n), bank.shape[0]))
    B = queries.shape[0]
    if B == 0:
        return _empty(k, bank.device)
    q = queries.float().contiguous()
    _check_aligned("bank scan", bank=bank, queries=q)
    out = _launch("bank_scan", B, k, D, n, bank, (n, D), q, stats)
    launches += 1
    return out


def _cosine_topk_fused_cuda(bank: torch.Tensor, inv_norms: torch.Tensor,
                            n: int, queries: torch.Tensor, k: int,
                            stats=None):
    global tile_scan_launches
    _check_scan_args("tile scan", bank, queries, k, KERNEL_K)
    _check_stats(stats)
    if inv_norms.shape != (bank.shape[0],) or inv_norms.device != bank.device:
        raise ValueError(f"inv_norms {tuple(inv_norms.shape)} on "
                         f"{inv_norms.device} do not match the bank "
                         f"{tuple(bank.shape)} on {bank.device}")
    D = bank.shape[1]
    n = max(0, min(int(n), bank.shape[0]))
    B = queries.shape[0]
    if B == 0:
        return _empty(k, bank.device)
    q = queries.float().contiguous()
    inv = inv_norms.float().contiguous()
    _check_aligned("tile scan", bank=bank, queries=q, inv_norms=inv)
    out = _launch("tile_scan", B, k, D, n, bank, (inv.data_ptr(), n, D), q,
                  stats)
    tile_scan_launches += 1
    return out


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
