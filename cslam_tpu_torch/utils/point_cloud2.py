"""Binary ``sensor_msgs/PointCloud2`` wire-format serde (ROS-free).

A copy of ``cslam_tpu/utils/point_cloud2.py`` (numpy only), carried into the
port so that it imports nothing of the JAX package.

The reference vendors a ROS utility for this
(reference ``cslam/utils/point_cloud2.py:61-348``) because every
lidar message it touches is a PointCloud2. This framework's internal
types are plain numpy arrays, but a user replaying recorded ROS data (or
bridging to a live DDS graph) still needs the binary layout: little/big
endian scalar fields at explicit byte offsets inside a fixed
``point_step`` stride, optionally organized as ``height x width``.

This module implements that layout from the public message spec with a
numpy-native design:

- ``dtype_of_cloud`` builds one structured dtype with explicit
  ``offsets``/``itemsize`` (padding bytes are never materialized as
  dummy fields; ``count > 1`` fields become subarrays),
- ``read_points`` is a zero-copy view wherever possible (copies only
  for endian conversion, NaN filtering, or index selection),
- ``make_cloud`` serializes any structured array — or a plain ``[N, 3]``
  float array via ``make_cloud_xyz32`` — back into a ``PointCloud2``.

Behavior parity notes vs the reference utility: NaN filtering drops a
point when ANY requested field is NaN (reference ll.100-109); ``uvs``
selects explicit point indices (ll.111-117); organized reshape returns
``height > 1`` clouds as 2D (ll.119-121); unnamed fields are readable
under generated names (l.236).
"""
from __future__ import annotations

import sys
from dataclasses import dataclass, field as dc_field
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "PointField", "PointCloud2", "dtype_of_cloud", "read_points",
    "read_points_numpy", "xyz_array", "make_cloud", "make_cloud_xyz32",
]

# sensor_msgs/PointField datatype codes (public ROS message constants).
_CODE_TO_NUMPY = {
    1: np.dtype(np.int8), 2: np.dtype(np.uint8),
    3: np.dtype(np.int16), 4: np.dtype(np.uint16),
    5: np.dtype(np.int32), 6: np.dtype(np.uint32),
    7: np.dtype(np.float32), 8: np.dtype(np.float64),
}
_NUMPY_TO_CODE = {v: k for k, v in _CODE_TO_NUMPY.items()}

_UNNAMED = "unnamed_field"


@dataclass
class PointField:
    """One field of a PointCloud2 (mirror of ``sensor_msgs/PointField``)."""
    name: str
    offset: int
    datatype: int
    count: int = 1

    INT8, UINT8, INT16, UINT16 = 1, 2, 3, 4
    INT32, UINT32, FLOAT32, FLOAT64 = 5, 6, 7, 8


@dataclass
class PointCloud2:
    """ROS-layout point cloud: raw bytes + field map (no rclpy needed)."""
    height: int
    width: int
    fields: List[PointField]
    point_step: int
    row_step: int
    data: bytes
    is_bigendian: bool = False
    is_dense: bool = True
    frame_id: str = ""
    stamp: float = 0.0

    @property
    def nb_points(self) -> int:
        return self.height * self.width


def dtype_of_cloud(fields: Sequence[PointField],
                   point_step: Optional[int] = None,
                   bigendian: bool = False) -> np.dtype:
    """Structured dtype for one point record.

    Explicit per-field ``offsets`` + ``itemsize = point_step`` encode any
    padding without dummy entries; a field with ``count > 1`` maps to a
    subarray. Empty field names get deterministic ``unnamed_field_{i}``
    placeholders so every field stays addressable (reference behavior,
    ``point_cloud2.py:236``).
    """
    order = ">" if bigendian else "<"
    names, formats, offsets = [], [], []
    for i, f in enumerate(fields):
        if f.datatype not in _CODE_TO_NUMPY:
            raise ValueError(f"unknown PointField datatype code {f.datatype}")
        base = _CODE_TO_NUMPY[f.datatype].newbyteorder(order)
        names.append(f.name if f.name else f"{_UNNAMED}_{i}")
        formats.append(base if f.count == 1 else (base, (f.count,)))
        offsets.append(f.offset)
    if point_step is None:
        point_step = max(
            off + _CODE_TO_NUMPY[f.datatype].itemsize * f.count
            for off, f in zip(offsets, fields))
    return np.dtype({"names": names, "formats": formats,
                     "offsets": offsets, "itemsize": point_step})


def read_points(cloud: PointCloud2,
                field_names: Optional[Iterable[str]] = None,
                skip_nans: bool = False,
                uvs: Optional[Iterable[int]] = None,
                reshape_organized_cloud: bool = False) -> np.ndarray:
    """Decode a PointCloud2 into a structured numpy array.

    Zero-copy view of ``cloud.data`` unless endian conversion, NaN
    filtering, or ``uvs`` selection forces a copy. Semantics match the
    reference utility (``point_cloud2.py:61-124``): ``field_names``
    restricts columns, ``skip_nans`` drops rows with any NaN (only
    consulted when the cloud is not marked dense), ``uvs`` picks explicit
    flat indices, ``reshape_organized_cloud`` returns 2D for organized
    clouds.
    """
    dt = dtype_of_cloud(cloud.fields, cloud.point_step, cloud.is_bigendian)
    pts = np.frombuffer(cloud.data, dtype=dt, count=cloud.nb_points)
    if field_names is not None:
        field_names = list(field_names)
        missing = [n for n in field_names if n not in (pts.dtype.names or ())]
        if missing:
            raise KeyError(f"fields {missing} not present in cloud "
                           f"(has {list(pts.dtype.names or ())})")
        pts = pts[field_names]
    native_big = sys.byteorder == "big"
    if bool(cloud.is_bigendian) != native_big:
        # non-destructive: astype to the native-order analogue
        pts = pts.astype(_native_dtype(pts.dtype), copy=True)
    filtered = False
    if skip_nans and not cloud.is_dense:
        keep = np.ones(len(pts), bool)
        for name in pts.dtype.names or ():
            col = pts[name]
            if np.issubdtype(col.dtype.base, np.floating):
                bad = np.isnan(col)
                keep &= ~(bad.any(axis=-1) if bad.ndim > 1 else bad)
        if not keep.all():
            # sensors often set is_dense=False conservatively; only an
            # actual drop destroys the organized grid
            pts = pts[keep]
            filtered = True
    if uvs is not None:
        idx = uvs if isinstance(uvs, np.ndarray) else np.fromiter(uvs, int)
        pts = pts[idx]
        filtered = True
    # the reference reshapes whenever height > 1 (ll.119-121) — but after
    # row filtering the organized grid no longer exists, so only reshape
    # when nothing was dropped/selected (a dense cloud with skip_nans=True
    # still reshapes: the filter was a no-op)
    if reshape_organized_cloud and cloud.height > 1 and not filtered:
        pts = pts.reshape(cloud.height, cloud.width)
    return pts


def _native_dtype(dt: np.dtype) -> np.dtype:
    names = dt.names or ()
    formats = []
    for n in names:
        sub = dt.fields[n][0]
        if sub.subdtype is not None:
            base, shape = sub.subdtype
            formats.append((base.newbyteorder("="), shape))
        else:
            formats.append(sub.newbyteorder("="))
    return np.dtype({"names": list(names), "formats": formats,
                     "offsets": [dt.fields[n][1] for n in names],
                     "itemsize": dt.itemsize})


def read_points_numpy(cloud: PointCloud2,
                      field_names: Optional[Iterable[str]] = None,
                      skip_nans: bool = False,
                      uvs: Optional[Iterable[int]] = None) -> np.ndarray:
    """Same-typed fields as a plain 2D array (reference ll.126-155).

    Defaults to every field; raises if the requested fields mix dtypes.
    """
    pts = read_points(cloud, field_names, skip_nans, uvs)
    names = pts.dtype.names or ()
    kinds = {pts.dtype.fields[n][0].base for n in names}
    if len(kinds) != 1:
        raise TypeError(
            f"fields {list(names)} mix dtypes {sorted(map(str, kinds))}; "
            "pass field_names selecting one dtype")
    return np.stack([np.asarray(pts[n]) for n in names], axis=-1)


def xyz_array(cloud: PointCloud2, skip_nans: bool = True) -> np.ndarray:
    """Fast path: the x/y/z columns as a float32 ``[N, 3]`` array.

    The shape every compute kernel here takes; equivalent of the
    reference's ``read_points_numpy_filtered`` (``point_cloud2.py:157-183``)
    which selects exactly the x/y/z fields.
    """
    pts = read_points(cloud, ["x", "y", "z"], skip_nans=skip_nans)
    return np.stack([np.asarray(pts[n], np.float32) for n in ("x", "y", "z")],
                    axis=-1)


def make_cloud(points: np.ndarray,
               fields: Optional[Sequence[PointField]] = None,
               height: int = 1,
               frame_id: str = "",
               stamp: float = 0.0,
               is_bigendian: bool = False) -> PointCloud2:
    """Serialize a structured array into a PointCloud2.

    ``fields`` defaults to a dense map inferred from ``points.dtype``
    (names, offsets from the dtype, datatype codes from the field base
    dtypes). Equivalent of the reference's ``create_cloud``
    (``point_cloud2.py:265-333``) without the ROS Header plumbing.
    """
    pts = np.asarray(points)
    if pts.dtype.names is None:
        raise TypeError("make_cloud needs a structured array; use "
                        "make_cloud_xyz32 for plain [N, 3] coordinates")
    if fields is None:
        fields = []
        for n in pts.dtype.names:
            sub, off = pts.dtype.fields[n][:2]
            if sub.subdtype is not None:
                base, (cnt,) = sub.subdtype[0], sub.subdtype[1]
            else:
                base, cnt = sub, 1
            code = _NUMPY_TO_CODE.get(base.newbyteorder("="))
            if code is None:
                raise TypeError(f"field {n!r} dtype {base} has no "
                                "PointField code")
            fields.append(PointField(n, off, code, cnt))
    wire_dt = dtype_of_cloud(fields, pts.dtype.itemsize, is_bigendian)
    flat = pts.reshape(-1)
    out = np.zeros(flat.shape[0], wire_dt)
    for n in flat.dtype.names:
        out[n] = flat[n]
    nb = flat.shape[0]
    if height < 1 or nb % height:
        raise ValueError(f"{nb} points do not tile height={height}")
    width = nb // height
    dense = True
    for n in flat.dtype.names:
        col = flat[n]
        if np.issubdtype(col.dtype.base, np.floating) and \
                np.isnan(col).any():
            dense = False
            break
    return PointCloud2(
        height=height, width=width, fields=list(fields),
        point_step=wire_dt.itemsize, row_step=wire_dt.itemsize * width,
        data=out.tobytes(), is_bigendian=is_bigendian, is_dense=dense,
        frame_id=frame_id, stamp=stamp)


def make_cloud_xyz32(points: np.ndarray, frame_id: str = "",
                     stamp: float = 0.0) -> PointCloud2:
    """``[N, 3]`` float coordinates -> dense 12-byte-stride cloud
    (reference ``create_cloud_xyz32``, ``point_cloud2.py:335-348``)."""
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    rec = np.zeros(pts.shape[0], dtype=[("x", "<f4"), ("y", "<f4"),
                                        ("z", "<f4")])
    rec["x"], rec["y"], rec["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
    return make_cloud(rec, frame_id=frame_id, stamp=stamp)
