"""A small PNG codec on the standard library's ``zlib`` and numpy.

The JAX package reads and writes the KITTI layout's images with Pillow
(``cslam_tpu/runtime/replay.py``); the port does not depend on it. This
codec covers what the KITTI odometry images use:

- reading: 8-bit grayscale (colour type 0) and 8-bit RGB (colour type 2),
  not interlaced, with any of the five row filters (none, sub, up,
  average, Paeth), in one or several ``IDAT`` chunks, CRCs checked;
- writing: the same two formats, every row with filter 0 (none).

Any other format (palette, alpha, 16-bit, interlaced) raises
:class:`PngFormatError` naming its colour type, bit depth and interlace
method. There is no fallback to another library.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3}            # colour type -> bytes per pixel (8-bit)
_COLOUR_NAMES = {0: "grayscale", 2: "RGB", 3: "palette",
                 4: "grayscale + alpha", 6: "RGBA"}


class PngFormatError(ValueError):
    """The file is not a PNG this codec reads, or is corrupt."""


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise PngFormatError("not a PNG file (bad signature)")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise PngFormatError(f"CRC mismatch in chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise PngFormatError("truncated PNG (no IEND chunk)")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, height: int, width: int,
              bpp: int) -> np.ndarray:
    """Undo the per-row filters of ``raw`` (``[H, 1 + W * bpp]``).

    Rows filtered with none, sub or up are undone a whole row at a time.
    Average and Paeth depend on the pixel to the left, so when a row uses
    them the image is undone along anti-diagonals (row r, column c depends
    only on (r, c - 1), (r - 1, c) and (r - 1, c - 1)): H + W - 1 numpy
    steps, each over every row at once."""
    ftype = raw[:, 0]
    if ftype.max(initial=0) > 4:
        raise PngFormatError(f"unknown row filter type {int(ftype.max())}")
    filt = raw[:, 1:].reshape(height, width, bpp)
    if not np.isin(ftype, (3, 4)).any():
        out = np.empty_like(filt)
        prev = np.zeros((width, bpp), np.uint8)
        for r in range(height):
            row = filt[r]
            if ftype[r] == 1:
                row = np.cumsum(row, axis=0, dtype=np.uint8)
            elif ftype[r] == 2:
                row = row + prev
            out[r] = prev = row
        return out
    # padded by one zero row on top and one zero column on the left
    x = np.zeros((height + 1, width + 1, bpp), np.int32)
    f = filt.astype(np.int32)
    ft = ftype.astype(np.int32)
    for d in range(height + width - 1):
        r = np.arange(max(0, d - width + 1), min(height, d + 1))
        c = d - r
        a, b, ul = x[r + 1, c], x[r, c + 1], x[r, c]
        kind = ft[r][:, None]
        pred = np.select(
            [kind == 1, kind == 2, kind == 3, kind == 4],
            [a, b, (a + b) >> 1, _paeth(a, b, ul)], default=0)
        x[r + 1, c + 1] = (f[r, c] + pred) & 0xFF
    return x[1:, 1:].astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """Pixels of a PNG file's bytes: ``[H, W]`` uint8 for grayscale,
    ``[H, W, 3]`` for RGB."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise PngFormatError("no IHDR chunk")
    width, height, depth, colour, _comp, _filter, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0:
        raise PngFormatError(
            f"unsupported PNG: colour type {colour} "
            f"({_COLOUR_NAMES.get(colour, 'unknown')}), bit depth {depth}, "
            f"interlace method {interlace}; this codec reads only 8-bit "
            "grayscale or RGB, not interlaced")
    bpp = _CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (1 + width * bpp):
        raise PngFormatError(f"image data holds {raw.size} bytes, expected "
                             f"{height * (1 + width * bpp)}")
    pixels = _unfilter(raw.reshape(height, 1 + width * bpp), height, width,
                       bpp)
    return pixels[:, :, 0] if bpp == 1 else pixels


def encode_png(image: np.ndarray) -> bytes:
    """A PNG file's bytes for ``[H, W]`` (grayscale) or ``[H, W, 3]`` (RGB)
    uint8 pixels, every row with filter 0."""
    img = np.asarray(image)
    if img.dtype != np.uint8 or not (
            img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise PngFormatError(f"cannot write {img.dtype} pixels of shape "
                             f"{img.shape}: 8-bit [H, W] or [H, W, 3] only")
    height, width = img.shape[:2]
    colour = 0 if img.ndim == 2 else 2
    rows = np.zeros((height, 1 + width * _CHANNELS[colour]), np.uint8)
    rows[:, 1:] = img.reshape(height, -1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    return (_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8,
                                         colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def write_png(path: str, image: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(image))


def to_luma(image: np.ndarray) -> np.ndarray:
    """8-bit luma of RGB pixels by ITU-R 601-2 in 16-bit fixed point,
    (19595 R + 38470 G + 7471 B + 2^15) >> 16, the rounding Pillow's
    ``convert("L")`` uses; grayscale passes through."""
    img = np.asarray(image)
    if img.ndim == 2:
        return img
    rgb = img.astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)
