"""One CUDA graph per input shape: the port's counterpart of ``jax.jit``'s
per-shape executable cache and of the JAX package's tier warmups.

The JAX package runs each verification chunk as one jitted program,
compiled once per power-of-two pair tier (at warmup, or at a tier's first
use). Eagerly, the same chunk is thousands of small kernels, each launched
from the host; the device then idles while the host launches. A
:class:`TierGraphs` captures its function once per key (input shapes and
dtypes, the device, and the static keywords, as ``jit``'s
``static_argnames``) as a ``torch.cuda.CUDAGraph``, and every later call
of that key copies its inputs into the graph's static buffers and replays
it: one launch per chunk.

- Every operand that varies per call (clouds, masks, thresholds, camera
  intrinsics) is a tensor, copied in at each call; only the static
  keywords are baked into a capture. The function may make no host read
  and no copy from pageable host memory: capture raises on either.
- The function runs twice eagerly on a side stream before its capture, so
  that its cuFFT plans, cuBLAS workspaces and allocator blocks exist; the
  function's own precision guard (``ops.highest_precision``) is active
  while it is captured, so the captured products are full float32.
- Each call returns clones of the static outputs: a caller may launch
  several chunks of one tier before it reads any
  (``registration.compute_transform_batch_begin``).
- Memory: every graph of a device allocates from one shared pool. That is
  safe here because replays are serialized on the caller's stream and each
  replay's outputs are cloned out before the next replay can overwrite a
  block the two graphs share; the pool then holds about the largest tier's
  working set instead of the sum over tiers. :func:`pool_bytes` reports
  what the captures reserved.
- A capture that fails raises, naming the function and the key; nothing
  falls back to the eager call on the card.
- On the CPU the function runs eagerly (the plain path); keys are recorded
  there too, so a CPU test can show that a warmup covers production's
  keys.

Counters (plain integers): ``captures`` and ``replays`` count on CUDA,
``keys_seen`` everywhere.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

_WARMUP_RUNS = 2
_POOLS: Dict[int, tuple] = {}
_POOL_BYTES: Dict[int, int] = {}


def pool_bytes(device=None) -> int:
    """Bytes the captures on ``device`` (default: the current CUDA device)
    reserved for the shared graph pool."""
    index = torch.device(device).index if device is not None else None
    if index is None:
        index = torch.cuda.current_device()
    return _POOL_BYTES.get(index, 0)


def host_operands(device, *values):
    """Float32 host tensors of arrays, tensors or scalars, for a
    :class:`TierGraphs` call on ``device``: pinned when ``device`` is CUDA
    (the copy into the static buffers then runs behind the device's
    queue). A tensor already on ``device``'s kind is passed through."""
    device = torch.device(device)
    out = []
    for v in values:
        if isinstance(v, torch.Tensor) and v.device.type == device.type:
            out.append(v.to(torch.float32))
            continue
        t = (v.detach().to("cpu", torch.float32) if isinstance(v, torch.Tensor)
             else torch.as_tensor(np.asarray(v, np.float32)))
        out.append(t.pin_memory() if device.type == "cuda" else t)
    return out


class TierGraphs:
    """``fn`` captured once per key and replayed (see the module note).

    Call as ``graphs(device, *tensors, **static)``: ``tensors`` are the
    operands (any device; copied into ``device``'s static buffers),
    ``static`` the hashable keywords that are part of the key. Returns
    ``fn``'s tuple of tensors on ``device``."""

    def __init__(self, fn: Callable, name: str):
        self.fn = fn
        self.name = name
        self.keys = set()
        self.captures = 0
        self.replays = 0
        self.pool_bytes = 0
        self._graphs: Dict[tuple, Tuple] = {}

    @property
    def keys_seen(self) -> int:
        return len(self.keys)

    def __call__(self, device, *args, **static):
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        key = (str(device),
               tuple((tuple(a.shape), a.dtype) for a in args),
               tuple(sorted(static.items())))
        self.keys.add(key)
        if device.type != "cuda":
            return self.fn(*(a.to(device) for a in args), **static)
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._graphs[key] = self._capture(key, device, args,
                                                      static)
        graph, inputs, outputs = entry
        for buf, a in zip(inputs, args):
            buf.copy_(a, non_blocking=True)
        graph.replay()
        self.replays += 1
        return tuple(o.clone() for o in outputs)

    def _capture(self, key, device, args, static):
        with torch.cuda.device(device):
            inputs = [torch.empty(a.shape, dtype=a.dtype, device=device)
                      .copy_(a) for a in args]
            try:
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    for _ in range(_WARMUP_RUNS):
                        self.fn(*inputs, **static)
                torch.cuda.current_stream().wait_stream(side)
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                reserved = torch.cuda.memory_reserved(device)
                if device.index not in _POOLS:
                    _POOLS[device.index] = torch.cuda.graph_pool_handle()
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=_POOLS[device.index]):
                    outputs = self.fn(*inputs, **static)
                torch.cuda.synchronize()
            except Exception as exc:
                raise RuntimeError(f"{self.name}: CUDA graph capture failed "
                                   f"for key {key}: {exc}") from exc
            grown = torch.cuda.memory_reserved(device) - reserved
        self.captures += 1
        self.pool_bytes += grown
        _POOL_BYTES[device.index] = _POOL_BYTES.get(device.index, 0) + grown
        if isinstance(outputs, torch.Tensor):
            outputs = (outputs,)
        return graph, inputs, tuple(outputs)
