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
- Captures run one at a time (they record into one pool), in
  ``thread_local`` mode: only the capturing thread is barred from calls a
  capture forbids (a synchronous copy, a pinned allocation, a device
  synchronize). The back end may capture a PGO tier in its optimization
  thread while the main thread's front end copies to the device
  (``tools/multi_process_swarm.py``); in the default global mode that
  copy fails.
- On the CPU the function runs eagerly (the plain path); keys are recorded
  there too, so a CPU test can show that a warmup covers production's
  keys.

Counters (plain integers): ``captures`` and ``replays`` count on CUDA,
``keys_seen`` everywhere.

:class:`StepGraphs` is the sibling for a loop: the programs of one
``lax.while_loop`` body (the PGO solver's LM and PCG steps, MAC's
Frank-Wolfe and LOBPCG steps) that share their loop state on the device,
each captured once per key and replayed until a device flag, read once per
block, says stop; an inner loop whose stop the host should not read at all
(LOBPCG) runs as a CUDA graph WHILE node.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import weakref
from typing import Callable, Dict, Tuple

import numpy as np
import torch

_WARMUP_RUNS = 2
_POOLS: Dict[int, tuple] = {}
_POOL_BYTES: Dict[int, int] = {}
# one capture at a time: every capture of a device records into its one
# shared pool, and two captures recording into a pool at once fail
_CAPTURE_LOCK = threading.RLock()


def pool_bytes(device=None) -> int:
    """Bytes the captures on ``device`` (default: the current CUDA device)
    reserved for the shared graph pool."""
    index = torch.device(device).index if device is not None else None
    if index is None:
        index = torch.cuda.current_device()
    return _POOL_BYTES.get(index, 0)


def synchronize(device=None) -> None:
    """``torch.cuda.synchronize(device)`` once no capture is in flight: a
    device-wide synchronize while another thread captures (a prefetch of
    the next selection tier, a back end's PGO tier) fails, and so does
    the capture."""
    with _CAPTURE_LOCK:
        torch.cuda.synchronize(device)


def host_operands(device, *values, dtype=torch.float32):
    """``dtype`` host tensors of arrays, tensors or scalars, for a
    :class:`TierGraphs` or :class:`StepGraphs` call on ``device``: pinned
    when ``device`` is CUDA (the copy into the static buffers then runs
    behind the device's queue). A tensor already on ``device``'s kind is
    passed through."""
    device = torch.device(device)
    out = []
    for v in values:
        if isinstance(v, torch.Tensor) and v.device.type == device.type:
            out.append(v.to(dtype))
            continue
        t = (v.detach().to("cpu", dtype) if isinstance(v, torch.Tensor)
             else torch.as_tensor(np.asarray(v), dtype=dtype))
        out.append(t.pin_memory() if device.type == "cuda" else t)
    return out


def _capture_in_pool(device, label, key, warm, body, keep_graph=False):
    """Capture ``body()`` as a CUDA graph in ``device``'s shared pool, after
    ``warm()`` has run ``_WARMUP_RUNS`` times on a side stream (and in
    ``thread_local`` mode, see the module note). Returns the graph,
    ``body``'s result and the bytes the capture reserved, which it also
    adds to :func:`pool_bytes`. ``keep_graph`` keeps the graph's
    ``cudaGraph_t`` (``raw_cuda_graph``). A failure raises, naming
    ``label`` and ``key``. Captures of all threads take turns (a thread
    that only replays does not wait)."""
    with _CAPTURE_LOCK, torch.cuda.device(device):
        try:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(_WARMUP_RUNS):
                    warm()
            torch.cuda.current_stream().wait_stream(side)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(device)
            if device.index not in _POOLS:
                _POOLS[device.index] = torch.cuda.graph_pool_handle()
            graph = (torch.cuda.CUDAGraph(keep_graph=True) if keep_graph
                     else torch.cuda.CUDAGraph())
            with torch.cuda.graph(graph, pool=_POOLS[device.index],
                                  capture_error_mode="thread_local"):
                result = body()
            torch.cuda.synchronize()
        except Exception as exc:
            raise RuntimeError(f"{label}: CUDA graph capture failed for key "
                               f"{key}: {exc}") from exc
        grown = torch.cuda.memory_reserved(device) - reserved
    _POOL_BYTES[device.index] = _POOL_BYTES.get(device.index, 0) + grown
    return graph, result, grown


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
        graph, outputs, grown = _capture_in_pool(
            device, self.name, key, lambda: self.fn(*inputs, **static),
            lambda: self.fn(*inputs, **static))
        self.captures += 1
        self.pool_bytes += grown
        if isinstance(outputs, torch.Tensor):
            outputs = (outputs,)
        return graph, inputs, tuple(outputs)


class StepGraphs:
    """Programs of one loop that share device state, each captured once
    per key and replayed: the counterpart of a jitted ``lax.while_loop``
    whose body is cut into a few programs.

    ``programs`` maps names to ``fn(state, operands, **static) -> dict``;
    ``state`` and ``operands`` are dicts of tensors, and the returned dict
    holds the state entries the program updates (every update is masked
    on the device, so a program run after the loop's stop leaves the state
    as it was). A solve binds its operands once::

        with graphs.solve(device, operands, **static) as loop:
            loop.run("init"); loop.run("step"); flag = loop.status()
            ... flag.wait() ...
            poses, = loop.take("poses")

    On CUDA the state lives in static buffers between replays (nothing is
    cloned per replay, only :meth:`_GraphLoop.take`'s outputs); the
    operands are copied in once per solve; a program's first run under a
    key runs it twice eagerly on a side stream, which shows the state
    buffers it writes (allocated outside the graph pool: they live across
    the replays of several graphs), then captures it, its updates copied
    into those buffers, its temporaries in the one shared pool of
    :class:`TierGraphs`. The key is
    the operands' names, shapes and dtypes, the device and ``static``, so
    caps and tolerances passed as tensors share one capture. A failed
    capture raises, naming the program and the key. On the CPU, or with
    ``eager=True`` (a test's way to run the same programs launched one by
    one), the programs run eagerly. ``status()`` starts a copy of the
    state's ``"status"`` tensor to pinned host memory behind the queue and
    returns a handle whose ``wait()`` is the loop's only host read. Solves
    of one key are serialized by that key's lock (its state buffers are
    shared); solves of other keys, such as a prefetch thread's captures
    of the next tier, do not wait for them. Counters as
    :class:`TierGraphs`', plus ``by_program``: captures and replays per
    program name, and ``captures_bg``: the captures made off the main
    thread (a prefetch's or a back end's, concurrent with the main
    loop).

    :meth:`_EagerLoop.run_while` runs a program while a 0-d bool entry of
    the state is set (the program clears it when its loop stops): the
    counterpart of an inner ``lax.while_loop``. On CUDA the program's
    capture becomes the body of a conditional WHILE node
    (``csrc/graph_while.cu``), so the whole inner loop is one launch with
    its stop test on the device and no iteration past it; eagerly the flag
    is read on the host before each run. :meth:`_EagerLoop.run_plan`
    generalizes it to a plan: a tuple whose items are program names, run
    in order, and ``(flag, plan)`` pairs, a loop over the inner plan while
    ``flag`` is set, nested to any depth (a whole jitted program of nested
    ``lax.while_loop``s). On CUDA the first run of a plan under a key
    captures its programs in the order of their first appearance, each
    replayed once after its capture so that the next one's warm runs see
    real state (that priming run's state is the plan's first program's to
    reset), then builds the plan as one executable graph; every run is one
    launch (``while_launches``). :meth:`_EagerLoop.put` writes a
    state entry from the host side (the result of a library call run
    between two programs)."""

    def __init__(self, name: str, programs: Dict[str, Callable]):
        self.name = name
        self.programs = programs
        self.keys = set()
        self.captures = 0
        self.captures_bg = 0
        self.replays = 0
        self.while_launches = 0
        self.pool_bytes = 0
        self.by_program = {n: collections.Counter() for n in programs}
        self._loops: Dict[tuple, "_GraphLoop"] = {}
        self._locks: Dict[tuple, threading.Lock] = {}
        self._meta = threading.Lock()   # keys, key locks and counters

    @property
    def keys_seen(self) -> int:
        return len(self.keys)

    @contextlib.contextmanager
    def solve(self, device, operands: Dict[str, torch.Tensor],
              eager: bool = False, **static):
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        key = (str(device),
               tuple((n, tuple(t.shape), t.dtype)
                     for n, t in operands.items()),
               tuple(sorted(static.items())))
        with self._meta:
            self.keys.add(key)
            lock = self._locks.setdefault(key, threading.Lock())
        with lock:
            if device.type != "cuda" or eager:
                yield _EagerLoop(self, {n: t.to(device, non_blocking=True)
                                        for n, t in operands.items()},
                                 static)
                return
            loop = self._loops.get(key)
            if loop is None:
                loop = self._loops[key] = _GraphLoop(self, key, device,
                                                     operands, static)
            loop.load(operands)
            yield loop

    def _count_launch(self, names) -> None:
        """One launch of a plan: a replay of each of its programs."""
        with self._meta:
            self.while_launches += 1
            self.replays += len(names)
            for name in names:
                self.by_program[name]["replays"] += 1

    def _count(self, name: str, what: str, grown: int = 0) -> None:
        """Add one to ``what`` (``captures`` or ``replays``), overall and
        for program ``name``, and ``grown`` pool bytes, under the set's
        lock (solves of several keys may run in several threads)."""
        with self._meta:
            setattr(self, what, getattr(self, what) + 1)
            self.by_program[name][what] += 1
            self.pool_bytes += grown
            if (what == "captures" and threading.current_thread()
                    is not threading.main_thread()):
                self.captures_bg += 1


class _Status:
    """A pending host copy of a loop's status tensor."""

    def __init__(self, status: torch.Tensor):
        if status.is_cuda:
            self._host = torch.empty(status.shape, dtype=status.dtype,
                                     pin_memory=True)
            self._host.copy_(status, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = status.clone(), None

    def wait(self) -> list:
        if self._event is not None:
            self._event.synchronize()
        return self._host.tolist()


class _EagerLoop:
    """The programs launched one by one (the plain path on the CPU)."""

    def __init__(self, graphs: StepGraphs, operands, static):
        self.graphs, self.operands, self.static = graphs, operands, static
        self.state: Dict[str, torch.Tensor] = {}

    def run(self, name: str) -> None:
        self.state.update(self.graphs.programs[name](
            self.state, self.operands, **self.static))

    def run_while(self, name: str, flag: str) -> None:
        self.run_plan(((flag, (name,)),))

    def run_plan(self, plan: tuple) -> None:
        for item in plan:
            if isinstance(item, str):
                self.run(item)
                continue
            flag, body = item
            while bool(self.state[flag]):
                self.run_plan(body)

    def put(self, **tensors) -> None:
        self.state.update(tensors)

    def status(self) -> _Status:
        return _Status(self.state["status"])

    def take(self, *names):
        return tuple(self.state[n] for n in names)


class _GraphLoop(_EagerLoop):
    """One key's static operand and state buffers and its captured
    programs. It refers to its :class:`StepGraphs` weakly: a set that is
    dropped (a test's own) frees its graphs at once, by reference count.
    Held in a reference cycle, they would wait for the garbage collector,
    which may run inside another capture; a graph's destructor calls the
    CUDA runtime, and that invalidates the capture."""

    def __init__(self, graphs: StepGraphs, key, device, operands, static):
        super().__init__(weakref.proxy(graphs),
                         {n: torch.empty(t.shape, dtype=t.dtype,
                                         device=device)
                          for n, t in operands.items()}, static)
        self.key, self.device = key, device
        self._captured: Dict[str, torch.cuda.CUDAGraph] = {}
        self._plans: Dict[tuple, "_PlanLoop"] = {}

    def load(self, operands) -> None:
        for n, t in operands.items():
            self.operands[n].copy_(t, non_blocking=True)

    def run(self, name: str) -> None:
        graph = self._captured.get(name)
        if graph is None:
            graph = self._captured[name] = self._capture(name)
        graph.replay()
        self.graphs._count(name, "replays")

    def run_while(self, name: str, flag: str) -> None:
        plan = ((flag, (name,)),)
        if plan not in self._plans and name not in self._captured:
            self._captured[name] = self._capture(name, True)
        self._launch(plan)

    def run_plan(self, plan: tuple) -> None:
        if plan not in self._plans:
            for name in _programs_of(plan):
                if name not in self._captured:
                    self._captured[name] = self._capture(name, True)
                    self.run(name)
        self._launch(plan)

    def _launch(self, plan: tuple) -> None:
        loop = self._plans.get(plan)
        if loop is None:
            loop = self._plans[plan] = _PlanLoop(
                plan, self._captured, self.state,
                f"{self.graphs.name}.{'/'.join(_programs_of(plan))}",
                self.key)
        loop.launch(self.device)
        self.graphs._count_launch(_programs_of(plan))

    def put(self, **tensors) -> None:
        for n, t in tensors.items():
            if n in self.state:
                self.state[n].copy_(t)
            else:
                self.state[n] = t.clone()

    def take(self, *names):
        return tuple(self.state[n].clone() for n in names)

    def _capture(self, name, keep_graph=False):
        fn = self.graphs.programs[name]

        def warm():
            # the state entries this program writes get buffers of their
            # own, outside the graph pool
            for n, o in fn(self.state, self.operands, **self.static).items():
                if n not in self.state:
                    self.state[n] = torch.empty_like(o)

        def body():
            for n, o in fn(self.state, self.operands, **self.static).items():
                self.state[n].copy_(o)

        graph, _, grown = _capture_in_pool(
            self.device, f"{self.graphs.name}.{name}", self.key, warm, body,
            keep_graph)
        self.graphs._count(name, "captures", grown)
        return graph


def _programs_of(plan: tuple) -> list:
    """A plan's program names in the order of their first appearance."""
    out = []
    for item in plan:
        for name in ((item,) if isinstance(item, str)
                     else _programs_of(item[1])):
            if name not in out:
                out.append(name)
    return out


class _PlanLoop:
    """A plan of captured programs and WHILE loops over them as one
    executable graph (``csrc/graph_while.cu``): one launch runs the plan,
    each loop repeating its body while its flag (a 0-d bool CUDA tensor
    of the state, which the body writes) is set. Keeps the captures it
    embeds alive (their graphs are embedded by copy, their tensors are
    the captures')."""

    def __init__(self, plan: tuple, graphs: Dict[str, torch.cuda.CUDAGraph],
                 state: Dict[str, torch.Tensor], label: str, key):
        import ctypes

        from cslam_tpu_torch.ops.nns import _lib_fn
        kinds, ptrs = [], []

        def walk(items):
            for item in items:
                if isinstance(item, str):
                    kinds.append(0)
                    ptrs.append(graphs[item].raw_cuda_graph())
                    continue
                flag, body = item
                t = state[flag]
                if t.dtype != torch.bool or t.numel() != 1 or not t.is_cuda:
                    raise ValueError(f"{label}: a while loop's flag is a 0-d "
                                     f"bool CUDA tensor, not {flag} "
                                     f"{t.dtype} {tuple(t.shape)}")
                kinds.append(1)
                ptrs.append(t.data_ptr())
                walk(body)
                kinds.append(2)
                ptrs.append(None)

        walk(plan)
        self.graphs = [graphs[n] for n in _programs_of(plan)]
        n = len(kinds)
        handle = ctypes.c_void_p()
        rc = _lib_fn("graph_while", "cslam_plan_create")(
            (ctypes.c_int * n)(*kinds), (ctypes.c_void_p * n)(*ptrs), n,
            ctypes.byref(handle))
        if rc != 0:
            raise RuntimeError(f"{label}: building the CUDA graph plan "
                               f"failed for key {key}: cudaError {rc}")
        self._handle = handle

    def launch(self, device) -> None:
        from cslam_tpu_torch.ops.nns import _lib_fn
        rc = _lib_fn("graph_while", "cslam_while_launch")(
            self._handle, torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"CUDA graph plan launch failed: "
                               f"cudaError {rc}")
