"""Carry state from the JAX package into the port, as numpy arrays.

The port never imports ``cslam_tpu``; a caller that holds the reference's
state (the parity tests do) passes its fields as numpy arrays:

- :func:`pose_graph_arrays_from_numpy` takes the fields of a ``cslam_tpu``
  ``PoseGraphArrays`` (``{field name: np.ndarray}``) and returns the port's
  ``PoseGraphArrays`` on ``device``;
- :func:`bank_from_numpy` builds a port ``DescriptorBank`` from the host
  rows, the valid count ``n`` and the item records of a reference bank.

This path carries no model weights; those come with the VPR models.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np

from cslam_tpu_torch import resolve_device
from cslam_tpu_torch.matching.nns_bank import DescriptorBank
from cslam_tpu_torch.pgo.factor_graph import PoseGraphArrays, arrays_from_numpy


def pose_graph_arrays_from_numpy(fields: Mapping[str, np.ndarray],
                                 device=None) -> PoseGraphArrays:
    """The port's ``PoseGraphArrays`` from a reference graph's fields."""
    return arrays_from_numpy(dict(fields), resolve_device(device))


def bank_from_numpy(rows: np.ndarray, n: int, items: Dict[int, Any],
                    capacity: Optional[int] = None, dtype: str = "float32",
                    device=None) -> DescriptorBank:
    """A port ``DescriptorBank`` holding the first ``n`` host ``rows`` (the
    reference bank's ``data``) with their ``items``; ``capacity`` defaults
    to the rows' length."""
    rows = np.asarray(rows, np.float32)
    bank = DescriptorBank(dim=rows.shape[1],
                          capacity=capacity or max(len(rows), 1),
                          dtype=dtype, device=device)
    bank.add_items(rows[:n], [items[i] for i in range(n)])
    return bank
