"""Pose-graph container bridging host bookkeeping and padded device arrays.

The host side mirrors what the reference builds out of GTSAM primitives in
``src/back_end/decentralized_pgo.cpp``: BetweenFactor chains from odometry
(cpp:233-266), intra/inter-robot loop-closure factors (cpp:268-320), a prior
on the local robot's first pose (cpp:836-845), keyed by (robot, keyframe) —
the TPU-era replacement for ``LabeledSymbol('g', 'A'+robot, kf)``
(``gtsam_utils.h:20-22``).

``to_arrays`` freezes the graph into power-of-two padded, fixed-shape
tensors on the solver's device (CUDA unless the caller passes another).
Counterpart of ``cslam_tpu/pgo/factor_graph.py``; the tier floors are kept.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from cslam_tpu_torch import resolve_device
from cslam_tpu_torch.types import PoseGraphEdge, PoseGraphValue, PoseKey

Key = Tuple[int, int]  # (robot_id, keyframe_id)


def _tier(n: int, minimum: int = 16) -> int:
    t = minimum
    while t < n:
        t *= 2
    return t


@dataclass
class PoseGraphArrays:
    """Padded, fixed-shape pose-graph tensors, all on one device."""

    poses: torch.Tensor        # [Np, 4, 4] initial estimates (identity padding)
    node_valid: torch.Tensor   # [Np] 0/1
    edge_i: torch.Tensor       # [Ne] int64
    edge_j: torch.Tensor       # [Ne] int64
    meas: torch.Tensor         # [Ne, 4, 4] relative measurements
    sqrt_info: torch.Tensor    # [Ne, 6] diagonal sqrt information (1/sigma)
    edge_valid: torch.Tensor   # [Ne] 0/1
    robust: torch.Tensor       # [Ne] 0/1 — subject to GNC reweighting
    prior_idx: torch.Tensor    # [B] int64 — nodes held by pose priors
    prior_pose: torch.Tensor   # [B, 4, 4] prior targets
    prior_sqrt_info: torch.Tensor  # [B, 6]
    prior_valid: torch.Tensor  # [B] 0/1

    @property
    def device(self) -> torch.device:
        return self.poses.device

    @property
    def num_nodes(self) -> int:
        return self.poses.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edge_i.shape[0]


class FactorGraph:
    """Host-side pose graph: insertion-ordered variables + between factors."""

    def __init__(self):
        self._index: Dict[Key, int] = {}
        self._poses: List[np.ndarray] = []
        self._edges: List[Tuple[int, int, np.ndarray, np.ndarray, bool]] = []
        self._priors: List[Tuple[int, np.ndarray, np.ndarray]] = []

    # ------------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._poses)

    def __contains__(self, key: Key) -> bool:
        return tuple(key) in self._index

    def keys(self) -> List[Key]:
        return list(self._index.keys())

    def index_of(self, key: Key) -> int:
        return self._index[tuple(key)]

    def add_variable(self, key: Key, pose: np.ndarray) -> int:
        """Insert (or update) a pose estimate for (robot, keyframe)."""
        key = tuple(key)
        if key in self._index:
            self._poses[self._index[key]] = np.asarray(pose, np.float64)
            return self._index[key]
        idx = len(self._poses)
        self._index[key] = idx
        self._poses.append(np.asarray(pose, np.float64))
        return idx

    def get_pose(self, key: Key) -> np.ndarray:
        return self._poses[self._index[tuple(key)]]

    def add_between(self, key_from: Key, key_to: Key, measurement: np.ndarray,
                    sigmas: np.ndarray, robust: bool = False) -> None:
        """BetweenFactor: measurement = X_from^-1 X_to, diagonal sigmas
        ordered [rot(3), trans(3)] like the reference noise model
        (``decentralized_pgo.cpp:64-70``)."""
        i = self._index[tuple(key_from)]
        j = self._index[tuple(key_to)]
        self._edges.append((i, j, np.asarray(measurement, np.float64),
                            np.asarray(sigmas, np.float64), robust))

    def add_prior(self, key: Key, pose: np.ndarray,
                  sigmas: np.ndarray) -> None:
        """Absolute pose prior. The centralized back end uses one as the
        gauge anchor (``decentralized_pgo.cpp:836-845``); the distributed
        mode adds one per separator pose received from neighbors."""
        self._priors.append((self._index[tuple(key)],
                             np.asarray(pose, np.float64),
                             np.asarray(sigmas, np.float64)))

    # ------------------------------------------------------------------

    def to_arrays(self, np_floor: int = 16,
                  ne_floor: int = 16, device=None) -> PoseGraphArrays:
        """Pad to power-of-two (pose, edge) tiers, at least the given
        floors. Deployments that know their mission bound pin the floors
        (``backend.pgo_np_floor``/``pgo_ne_floor``) so ONE compiled solver
        program covers every optimization round — same rationale as the
        MAC ``mac_e_floor``/``mac_p_floor`` axes (a mid-mission tier
        crossing pays a full remote compile, 330-433 s for the big GNC
        tiers on the relay-attached chip). The tensors land on ``device``
        (CUDA unless the caller passes another)."""
        device = resolve_device(device)
        n, m = len(self._poses), len(self._edges)
        Np = _tier(max(n, 1), minimum=max(16, np_floor))
        Ne = _tier(max(m, 1), minimum=max(16, ne_floor))

        poses = np.tile(np.eye(4, dtype=np.float32), (Np, 1, 1))
        if n:
            poses[:n] = np.stack(self._poses).astype(np.float32)
        node_valid = np.zeros(Np, np.float32)
        node_valid[:n] = 1.0

        ei = np.zeros(Ne, np.int32)
        ej = np.zeros(Ne, np.int32)
        meas = np.tile(np.eye(4, dtype=np.float32), (Ne, 1, 1))
        sqrt_info = np.ones((Ne, 6), np.float32)
        edge_valid = np.zeros(Ne, np.float32)
        robust = np.zeros(Ne, np.float32)
        for k, (i, j, z, s, rb) in enumerate(self._edges):
            ei[k], ej[k] = i, j
            meas[k] = z.astype(np.float32)
            sqrt_info[k] = (1.0 / np.maximum(s, 1e-9)).astype(np.float32)
            edge_valid[k] = 1.0
            robust[k] = float(rb)

        priors = self._priors or [(0, self._poses[0] if n else np.eye(4),
                                   np.full(6, 0.1))]
        Nb = _tier(len(priors), minimum=1)
        p_idx = np.zeros(Nb, np.int32)
        p_pose = np.tile(np.eye(4, dtype=np.float32), (Nb, 1, 1))
        p_info = np.ones((Nb, 6), np.float32)
        p_valid = np.zeros(Nb, np.float32)
        for k, (idx, pose, sig) in enumerate(priors):
            p_idx[k] = idx
            p_pose[k] = pose.astype(np.float32)
            p_info[k] = (1.0 / np.maximum(sig, 1e-9)).astype(np.float32)
            p_valid[k] = 1.0

        return arrays_from_numpy(dict(
            poses=poses, node_valid=node_valid, edge_i=ei, edge_j=ej,
            meas=meas, sqrt_info=sqrt_info, edge_valid=edge_valid,
            robust=robust, prior_idx=p_idx, prior_pose=p_pose,
            prior_sqrt_info=p_info, prior_valid=p_valid), device)

    def edges_as_records(self) -> List[PoseGraphEdge]:
        """Between factors as typed records (for g2o export / logging)."""
        inv = {v: k for k, v in self._index.items()}
        return [PoseGraphEdge(key_from=PoseKey(*inv[i]), key_to=PoseKey(*inv[j]),
                              measurement=z, noise_sigmas=s)
                for (i, j, z, s, _r) in self._edges]

    def values_from_arrays(self, poses) -> List[PoseGraphValue]:
        out = []
        host = _host(poses)
        for key, idx in self._index.items():
            out.append(PoseGraphValue(key=PoseKey(*key),
                                      pose=host[idx].astype(np.float64)))
        return out

    def update_from_arrays(self, poses) -> None:
        host = _host(poses).astype(np.float64)
        for key, idx in self._index.items():
            self._poses[idx] = host[idx]


def _host(poses) -> np.ndarray:
    if isinstance(poses, torch.Tensor):
        return poses.detach().cpu().numpy()
    return np.asarray(poses)


_INDEX_FIELDS = ("edge_i", "edge_j", "prior_idx")


def arrays_from_numpy(fields: Dict[str, np.ndarray],
                      device) -> PoseGraphArrays:
    """PoseGraphArrays from numpy fields: index fields become int64
    tensors, the rest float32, all on ``device``."""
    out = {}
    for name, value in fields.items():
        dtype = torch.int64 if name in _INDEX_FIELDS else torch.float32
        out[name] = torch.tensor(np.asarray(value), dtype=dtype,
                                 device=device)
    return PoseGraphArrays(**out)


def arrays_to_numpy(arrays: PoseGraphArrays) -> Dict[str, np.ndarray]:
    """The fields of ``arrays`` as host numpy arrays in the JAX package's
    dtypes (int32 indices, float32 the rest): the layout of a
    ``CSLAM_TPU_DUMP_PGO`` file, which either package's replay reads back
    with :func:`arrays_from_numpy` or its own loader."""
    return {f.name: _host(getattr(arrays, f.name)).astype(
        np.int32 if f.name in _INDEX_FIELDS else np.float32)
        for f in dataclasses.fields(PoseGraphArrays)}
