"""Overlapped host reads of device tensors.

Counterpart of ``cslam_tpu/utils/device_read.py``. When several results are
pending (one per robot per poll cycle in the single-process simulator, or
several search/selection handles queued by the detection plane), issuing all
device->host copies first and only then blocking lets the copies run behind
the device's queue instead of serializing one wait per read.

``prefetch`` starts a ``non_blocking`` copy of each CUDA tensor into pinned
host memory and records a CUDA event after it; :func:`to_numpy` then waits
for that event and hands back the copy. ``ready`` asks the event (or a new
one recorded now) with ``torch.cuda.Event.query()`` — no wait. CPU tensors
and numpy arrays are always ready.
"""
from __future__ import annotations

from typing import Iterable, List

import numpy as np
import torch


def prefetch(arrays: Iterable) -> None:
    """Start async device->host copies for every CUDA tensor."""
    for a in arrays:
        if (not isinstance(a, torch.Tensor) or not a.is_cuda
                or hasattr(a, "_host_copy")):
            continue
        host = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
        host.copy_(a, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        a._host_copy = (host, event)


def to_numpy(a) -> np.ndarray:
    """Host copy of one tensor (uses a pending :func:`prefetch` copy)."""
    if not isinstance(a, torch.Tensor):
        return np.asarray(a)
    pending = getattr(a, "_host_copy", None)
    if pending is not None:
        host, event = pending
        event.synchronize()
        return host.numpy()
    return a.detach().cpu().numpy()


def fetch(arrays: Iterable) -> List[np.ndarray]:
    """Materialize several tensors with overlapped copies."""
    arrs = list(arrays)
    prefetch(arrs)
    return [to_numpy(a) for a in arrs]


def ready(arrays: Iterable) -> bool:
    """True when every tensor's producing work has finished (no wait)."""
    for a in arrays:
        if not isinstance(a, torch.Tensor) or not a.is_cuda:
            continue
        pending = getattr(a, "_host_copy", None)
        if pending is not None:
            event = pending[1]
        else:
            event = torch.cuda.Event()
            event.record()
        if not event.query():
            return False
    return True
