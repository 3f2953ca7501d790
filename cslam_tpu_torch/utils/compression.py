"""Local-descriptor payload compression for the descriptor-exchange plane.

A copy of ``cslam_tpu/utils/compression.py`` (numpy only), carried into the
port so that it imports nothing of the JAX package.

The reference never ships raw feature arrays: the RGBD handler transmits
rtabmap-*compressed* keypoints/descriptors and logs the compressed sizes
(reference ``src/front_end/rgbd_handler.cpp:404-431``). This module
is the equivalent for the numpy-native message schema: arrays are
packed as ``dtype/shape header + zlib deflate`` blobs, with an optional
lossy float16 pre-quantization tier for point payloads (keypoint pixel
coords and camera/lidar-frame points fit comfortably in f16's 11-bit
mantissa at centimeter precision; binary BRIEF descriptors are always
lossless).

Host-side on purpose: compression sits on the messaging plane, which never
blocks device compute. zlib level 1 measures within
a few percent of level 6 on BRIEF/keypoint payloads at ~5x less CPU.
"""
from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

# wire header: dtype tag, ndim, then ndim uint32 dims
_DTYPES = {0: np.uint8, 1: np.float32, 2: np.float16, 3: np.int32,
           4: np.uint16, 5: np.float64, 6: np.int64}
_TAGS = {np.dtype(v): k for k, v in _DTYPES.items()}


def compress_array(a: np.ndarray, level: int = 1,
                   quantize_f16: bool = False) -> bytes:
    """Pack an array as ``header + deflate(data)`` bytes.

    ``quantize_f16`` drops float32/float64 payloads to float16 before the
    lossless stage (lossy; ~0.1% relative error — fine for pixel/metric
    coordinates, never for descriptors you hamming-match bit-exactly).
    """
    a = np.ascontiguousarray(a)
    if quantize_f16 and a.dtype in (np.float32, np.float64):
        a = a.astype(np.float16)
    tag = _TAGS.get(a.dtype)
    if tag is None:
        raise TypeError(f"unsupported dtype {a.dtype}")
    header = struct.pack("<BB", tag, a.ndim) + struct.pack(
        f"<{a.ndim}I", *a.shape)
    return header + zlib.compress(a.tobytes(), level)


def decompress_array(blob: bytes) -> np.ndarray:
    """Inverse of :func:`compress_array`. f16-quantized payloads come back
    as float32 (the schema dtype of every point/keypoint field)."""
    tag, ndim = struct.unpack_from("<BB", blob, 0)
    shape = struct.unpack_from(f"<{ndim}I", blob, 2)
    dtype = np.dtype(_DTYPES[tag])
    data = np.frombuffer(zlib.decompress(blob[2 + 4 * ndim:]), dtype)
    a = data.reshape(shape)
    if a.dtype == np.float16:
        a = a.astype(np.float32)
    return a


def maybe_decompress(blob) -> Optional[np.ndarray]:
    if blob is None:
        return None
    if isinstance(blob, np.ndarray):  # uncompressed peer (knob off)
        return blob
    return decompress_array(blob)


def payload_nbytes(blob) -> int:
    """Actual on-wire size of a (possibly compressed) field."""
    if blob is None:
        return 0
    if isinstance(blob, np.ndarray):
        return blob.nbytes
    return len(blob)
