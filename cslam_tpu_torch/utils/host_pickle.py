"""Pickling that refuses device state.

Wire frames (``runtime/transport.py``) and robot snapshots
(``utils/snapshot.py``) must hold host objects only: a pickled
``torch.Tensor`` would rebuild one process's device tensor in another, or
tie a snapshot to the device it was taken on. :func:`dumps` pickles like
``pickle.dumps`` at the highest protocol and raises ``TypeError`` on any
tensor inside the object. It does not import ``torch``: where no module
has imported it, no object can be a tensor.
"""
from __future__ import annotations

import io
import pickle
import sys
from typing import Any


class _HostPickler(pickle.Pickler):
    def reducer_override(self, obj):
        torch = sys.modules.get("torch")
        if torch is not None and isinstance(obj, torch.Tensor):
            raise TypeError(
                f"refusing to pickle a torch.Tensor ({tuple(obj.shape)}, "
                f"{obj.dtype}, {obj.device}): convert it to numpy first")
        return NotImplemented


def dumps(obj: Any) -> bytes:
    buf = io.BytesIO()
    _HostPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()
