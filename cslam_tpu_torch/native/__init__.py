"""ctypes loader for the port's native (C++) host components.

Counterpart of ``cslam_tpu/native/__init__.py``, with the same names:
:func:`available`, :func:`fast_detect`, :func:`brief_describe`,
:func:`steered_brief_describe` and :func:`hamming_match`. The feature
extraction of the visual front end stays on the host in C++, as it does in
the JAX package and in the reference (rtabmap's Feature2D,
``src/front_end/rgbd_handler.cpp:266-312``): ``features.cpp`` here is the
port's own copy of the JAX package's ``native/features.cpp`` (FAST-9,
BRIEF-256, steered BRIEF, mutual hamming matching with a Lowe ratio test,
behind a plain C ABI), compiled at first use with one
``g++ -O3 -march=native -fPIC -shared -std=c++17``.

What differs from the JAX package, and why:
- The library is built into ``cslam_tpu_torch/csrc/build/`` under a name
  tagged with a hash of the source, the flags and the host's CPU (the
  library is built for the CPU it runs on), never into ``native/``: the
  JAX package's ``native/libcslam_native.so`` is not touched.
- The compiler writes a private temporary file that is renamed into place,
  so test workers building at once never load a half-written library.
- There is no silent fallback: a failed build or a missing symbol raises
  with the compiler's output in the message. The pure-NumPy
  ``native.fallback`` is the tests' oracle only.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "features.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "csrc" / "build"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"]
#: the C entry points every library must export
SYMBOLS = ("cslam_fast_detect", "cslam_brief_describe",
           "cslam_steered_brief_describe", "cslam_hamming_match")


class NativeBuildError(RuntimeError):
    """The feature library could not be built or lacks an entry point."""


_lib: Optional[ctypes.CDLL] = None
_error: Optional[NativeBuildError] = None
_lock = threading.Lock()


def _cpu_tag() -> bytes:
    """The host CPU's model and feature flags (``-march=native`` builds for
    them), or nothing where ``/proc/cpuinfo`` is not there."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return b""
    keep = [ln for ln in lines if ln.startswith(("model name", "flags"))]
    return "\n".join(keep[:2]).encode()


def library_path(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    """Where :func:`build` puts the library of ``source``."""
    tag = hashlib.sha1(source.read_bytes() + " ".join(CXX_FLAGS).encode()
                       + _cpu_tag()).hexdigest()[:12]
    return build_dir / f"libcslam_features_{tag}.so"


def build(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``source`` (once per version of it) and return the library's
    path. Raises :class:`NativeBuildError` with the compiler's output when
    the compiler is missing or fails."""
    out = library_path(source, build_dir)
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeBuildError("g++ not found: the feature library is "
                               f"built from {source} at first use")
    build_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(source)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise NativeBuildError(f"g++ failed to build {source.name}:\n"
                                   f"{proc.stderr}{proc.stdout}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def bind(path: Path) -> ctypes.CDLL:
    """Load the library at ``path`` and declare its entry points; raises
    :class:`NativeBuildError` when one is missing."""
    lib = ctypes.CDLL(str(path))
    missing = [s for s in SYMBOLS if not hasattr(lib, s)]
    if missing:
        raise NativeBuildError(f"{path} lacks {', '.join(missing)}")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    ci = ctypes.c_int
    lib.cslam_fast_detect.restype = ci
    lib.cslam_fast_detect.argtypes = [u8p, ci, ci, ci, ci, ci, i32p, i32p]
    lib.cslam_brief_describe.restype = None
    lib.cslam_brief_describe.argtypes = [u8p, ci, ci, i32p, ci, u8p]
    lib.cslam_steered_brief_describe.restype = None
    lib.cslam_steered_brief_describe.argtypes = [u8p, ci, ci, i32p, ci, u8p,
                                                 f32p]
    lib.cslam_hamming_match.restype = ci
    lib.cslam_hamming_match.argtypes = [u8p, ci, u8p, ci, ci, ctypes.c_float,
                                        i32p, ci]
    return lib


def _load() -> ctypes.CDLL:
    """The bound library, built at first use; a failure is kept and raised
    again at every later call (no retry, no fallback)."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                _lib = bind(build(SOURCE, BUILD_DIR))
            except (NativeBuildError, OSError, subprocess.SubprocessError
                    ) as exc:
                _error = (exc if isinstance(exc, NativeBuildError)
                          else NativeBuildError(str(exc)))
        if _error is not None:
            raise _error
        return _lib


def available() -> bool:
    """True when the C++ library is built and loaded (a failed build is
    raised by the feature functions, never replaced by the oracle)."""
    try:
        _load()
    except NativeBuildError:
        return False
    return True


def fast_detect(image: np.ndarray, threshold: int = 25, max_kp: int = 512,
                grid_cells: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """FAST-9 corners: returns (xy [N,2] int32, scores [N] int32)."""
    lib = _load()
    image = np.ascontiguousarray(image, np.uint8)
    h, w = image.shape
    out_xy = np.zeros((max_kp, 2), np.int32)
    out_score = np.zeros(max_kp, np.int32)
    n = lib.cslam_fast_detect(image, h, w, threshold, max_kp, grid_cells,
                              out_xy, out_score)
    return out_xy[:n], out_score[:n]


def brief_describe(image: np.ndarray, kp_xy: np.ndarray) -> np.ndarray:
    """BRIEF-256: (image, [N,2] int32) -> [N, 32] uint8 descriptors."""
    lib = _load()
    image = np.ascontiguousarray(image, np.uint8)
    kp_xy = np.ascontiguousarray(kp_xy, np.int32)
    h, w = image.shape
    out = np.zeros((len(kp_xy), 32), np.uint8)
    if len(kp_xy):
        lib.cslam_brief_describe(image, h, w, kp_xy, len(kp_xy), out)
    return out


def steered_brief_describe(image: np.ndarray, kp_xy: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """ORB-style steered BRIEF-256: the sampling pattern is rotated by
    each keypoint's intensity-centroid orientation. Returns
    (descriptors [N,32] uint8, angles [N] float32 radians)."""
    lib = _load()
    image = np.ascontiguousarray(image, np.uint8)
    kp_xy = np.ascontiguousarray(kp_xy, np.int32)
    h, w = image.shape
    out = np.zeros((len(kp_xy), 32), np.uint8)
    angles = np.zeros(len(kp_xy), np.float32)
    if len(kp_xy):
        lib.cslam_steered_brief_describe(image, h, w, kp_xy, len(kp_xy),
                                         out, angles)
    return out, angles


def hamming_match(desc_a: np.ndarray, desc_b: np.ndarray,
                  max_dist: int = 64, ratio: float = 0.0) -> np.ndarray:
    """Mutual-NN hamming matches: returns [M, 2] int32 index pairs.
    ``ratio`` > 0 adds a Lowe ratio test (best <= ratio * second-best)."""
    lib = _load()
    desc_a = np.ascontiguousarray(desc_a, np.uint8)
    desc_b = np.ascontiguousarray(desc_b, np.uint8)
    max_pairs = min(len(desc_a), len(desc_b))
    out = np.zeros((max(max_pairs, 1), 2), np.int32)
    n = lib.cslam_hamming_match(desc_a, len(desc_a), desc_b, len(desc_b),
                                max_dist, ctypes.c_float(ratio), out,
                                max_pairs)
    return out[:n]
