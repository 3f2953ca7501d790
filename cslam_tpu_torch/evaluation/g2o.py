"""g2o-format pose-graph I/O.

Parity with the reference's ``gtsam::writeG2o`` usage (dumps at
``decentralized_pgo.cpp:322-330`` and ``logger.cpp:82-103``): poses are
``VERTEX_SE3:QUAT``, between factors are ``EDGE_SE3:QUAT`` with an upper
-triangular information matrix. Keys (robot, keyframe) are packed the way
GTSAM LabeledSymbols serialize — here simply ``robot_id * 2**32 + kf`` so
multi-robot graphs round-trip.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from cslam_tpu_torch.types import PoseGraphEdge, PoseKey

_KEY_BASE = 1 << 32


def _pack(key: Tuple[int, int]) -> int:
    return key[0] * _KEY_BASE + key[1]


def _unpack(packed: int) -> Tuple[int, int]:
    return packed // _KEY_BASE, packed % _KEY_BASE


def _mat_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (x, y, z, w)."""
    from scipy.spatial.transform import Rotation
    return Rotation.from_matrix(R).as_quat()


def _quat_to_mat(q: np.ndarray) -> np.ndarray:
    from scipy.spatial.transform import Rotation
    return Rotation.from_quat(q).as_matrix()


def write_g2o(path: str, values: Dict[Tuple[int, int], np.ndarray],
              edges: List[PoseGraphEdge]) -> None:
    with open(path, "w") as f:
        for key in sorted(values):
            T = np.asarray(values[key])
            q = _mat_to_quat(T[:3, :3])
            t = T[:3, 3]
            f.write(f"VERTEX_SE3:QUAT {_pack(key)} "
                    f"{t[0]:.9g} {t[1]:.9g} {t[2]:.9g} "
                    f"{q[0]:.9g} {q[1]:.9g} {q[2]:.9g} {q[3]:.9g}\n")
        for e in edges:
            T = np.asarray(e.measurement)
            q = _mat_to_quat(T[:3, :3])
            t = T[:3, 3]
            # diagonal information from sigmas; g2o stores the upper triangle
            # of the 6x6 info matrix in (t, r) block order
            info = np.zeros((6, 6))
            inv_var = 1.0 / np.square(np.asarray(e.noise_sigmas))
            info[:3, :3] = np.diag(inv_var[3:])  # translation block
            info[3:, 3:] = np.diag(inv_var[:3])  # rotation block
            upper = [info[i, j] for i in range(6) for j in range(i, 6)]
            f.write(f"EDGE_SE3:QUAT {_pack(e.key_from.as_tuple())} "
                    f"{_pack(e.key_to.as_tuple())} "
                    f"{t[0]:.9g} {t[1]:.9g} {t[2]:.9g} "
                    f"{q[0]:.9g} {q[1]:.9g} {q[2]:.9g} {q[3]:.9g} "
                    + " ".join(f"{v:.9g}" for v in upper) + "\n")


def read_g2o(path: str):
    """Returns (values dict, edges list)."""
    values: Dict[Tuple[int, int], np.ndarray] = {}
    edges: List[PoseGraphEdge] = []
    with open(path) as f:
        for line in f:
            fields = line.split()
            if not fields:
                continue
            if fields[0] == "VERTEX_SE3:QUAT":
                key = _unpack(int(fields[1]))
                t = np.array([float(x) for x in fields[2:5]])
                q = np.array([float(x) for x in fields[5:9]])
                T = np.eye(4)
                T[:3, :3] = _quat_to_mat(q)
                T[:3, 3] = t
                values[key] = T
            elif fields[0] == "EDGE_SE3:QUAT":
                k0, k1 = _unpack(int(fields[1])), _unpack(int(fields[2]))
                t = np.array([float(x) for x in fields[3:6]])
                q = np.array([float(x) for x in fields[6:10]])
                T = np.eye(4)
                T[:3, :3] = _quat_to_mat(q)
                T[:3, 3] = t
                upper = [float(x) for x in fields[10:31]]
                info = np.zeros((6, 6))
                idx = 0
                for i in range(6):
                    for j in range(i, 6):
                        info[i, j] = info[j, i] = upper[idx]
                        idx += 1
                diag = np.maximum(np.diag(info), 1e-12)
                sigmas = np.concatenate([1.0 / np.sqrt(diag[3:]),
                                         1.0 / np.sqrt(diag[:3])])
                edges.append(PoseGraphEdge(
                    key_from=PoseKey(*k0), key_to=PoseKey(*k1),
                    measurement=T, noise_sigmas=sigmas))
    return values, edges
