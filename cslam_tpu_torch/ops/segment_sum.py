"""Sums of rows into segments in a fixed order: the hand-written CUDA
kernel behind every normal-equation sum of the PGO solvers, and its
plain PyTorch version.

Replaces no TPU kernel. The JAX package sums its normal equations with
one-hot matmuls (``cslam_tpu/pgo/solver.py:154-195``; the coarse alignment
with an ``einsum`` over ``Jfull``, ``cslam_tpu/pgo/distributed.py:380-400``):
every run adds in the same order, so a run repeats. The port summed with ``index_add_`` /
``index_put_(accumulate=True)``, which on the card are atomics whose order
changes from run to run, so two eager runs of one problem drifted apart.
Here the order is fixed once per problem:

- A :class:`SegmentPlan` is built from the index arrays, which are fixed
  per problem (:func:`segment_plan`): a stable sort of the destination
  keys gives ``perm``, the sources in destination order and, within a
  destination, in source order, and ``offsets``, each destination's range
  of ``perm`` (CSR). Sources marked invalid (padding) are left out: they
  are exact zeros, and adding a zero to a sum that starts from +0.0
  changes no bit of it. The plan is made with device ops only (no host
  read), outside every captured program, and its tensors have a static
  shape per tier, so it enters the step programs as operands.
- :func:`segment_sum` adds each destination's sources in ``perm``'s order,
  from +0.0, one float32 add at a time. That is the order of the CPU's
  ``index_add_`` over the concatenated sources (it adds index by index),
  so on the CPU the port gives the bits it gave before, and the kernel
  gives the same bits as its plain version (:func:`segment_sum_ref`, a
  ``torch.segment_reduce`` over the plan: the same sequential adds, and
  no host read, so a CPU solve reads no more than a CUDA one).

A plan has two forms. With ``dest`` None a segment is a destination row:
``offsets`` has ``rows + 1`` entries (a per-node sum). In the compact form
(``compact=True``, sums into a dense ``[rows, rows]`` matrix, whose
``rows + 1`` offsets would not fit at the large tiers) the segments are
the distinct keys present, at most one per source, ``dest`` names each
one's row, and an empty segment's ``dest`` is a row past ``rows`` of its
own (``rows + s``), so :func:`segment_sum` places the sums by an
``index_copy_`` with unique indices.

The kernel (``csrc/segment_sum.cu``): one warp per destination row (or
``32 // C`` rows per warp for a narrow row), one lane per component (C =
6, 36, 3, ...), each lane adding its component's sources in CSR order with
``__fadd_rn`` (no contraction), built with ``--fmad=false`` by
``ops.nns.build`` at first use. It is bound by bytes: each source row is
read once and each destination row written once. Every launch adds one to
a per-device int64 on the device (:func:`device_launch_count`), since the
solvers' step programs replay it from CUDA graphs with no host call.

:func:`segment_sum` runs :func:`segment_sum_ref` for a CPU tensor and, for
a CUDA tensor, launches the kernel or raises; it never falls back to an
atomic sum.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

#: the wrapper's kernel launches from the host since import (or since
#: :func:`reset_launches`): eager calls and the launches a capture records
launches = 0
#: per CUDA device index: int64 [1], the kernel's own count of its runs
_DEVICE_COUNTS: Dict[int, torch.Tensor] = {}

_FIELDS = ("perm", "offsets", "dest")


class SegmentPlan(NamedTuple):
    """The fixed summation order of one sum (see the module note)."""

    perm: torch.Tensor                   # [n_src] int64 source rows
    offsets: torch.Tensor                # [n_seg + 1] int64 CSR offsets
    dest: Optional[torch.Tensor] = None  # [n_seg] int64 rows (compact form)


def segment_plan(keys: torch.Tensor, valid: torch.Tensor, rows: int,
                 compact: bool = False) -> SegmentPlan:
    """The plan of a sum of sources ``k`` into rows ``keys[k]`` (each in
    ``[0, rows)``), leaving out the sources where ``valid`` is False.
    Device ops only: no host read. Raises inside a CUDA graph capture (a
    plan is made once per problem, before its programs run)."""
    if keys.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("segment_sum: a plan is made before a CUDA graph "
                           "capture, not inside one")
    keys = keys.reshape(-1).to(torch.int64)
    valid = valid.reshape(-1).to(torch.bool)
    n, dev = keys.numel(), keys.device
    # invalid sources sort after every key (stable: source order kept)
    sorted_keys, perm = torch.sort(
        torch.where(valid, keys, torch.full_like(keys, rows)), stable=True)
    if not compact:
        return SegmentPlan(perm, torch.searchsorted(
            sorted_keys, torch.arange(rows + 1, device=dev)))
    live = sorted_keys < rows
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = sorted_keys[1:] != sorted_keys[:-1]
    seg = torch.where(live, torch.cumsum(first & live, 0) - 1,
                      torch.full_like(keys, n))
    offsets = torch.searchsorted(seg, torch.arange(n + 1, device=dev))
    head = sorted_keys[torch.clamp(offsets[:-1], max=max(n - 1, 0))]
    spare = rows + torch.arange(n, device=dev)
    return SegmentPlan(
        perm, offsets, torch.where(offsets[:-1] < offsets[1:], head, spare))


def plan_operands(name: str, plan: SegmentPlan) -> Dict[str, torch.Tensor]:
    """``plan``'s tensors as step-program operands ``{name}_perm``, ..."""
    return {f"{name}_{f}": t for f, t in zip(_FIELDS, plan) if t is not None}


def plan_from(operands: dict, name: str) -> Optional[SegmentPlan]:
    """The plan :func:`plan_operands` put into ``operands`` (None if
    absent)."""
    if f"{name}_perm" not in operands:
        return None
    return SegmentPlan(*(operands.get(f"{name}_{f}") for f in _FIELDS))


def _check(src: torch.Tensor, plan: SegmentPlan, rows) -> None:
    if src.dtype != torch.float32 or src.dim() != 2:
        raise ValueError(f"segment_sum takes float32 [n, C] sources, not "
                         f"{src.dtype} {tuple(src.shape)}")
    if src.shape[0] != plan.perm.shape[0]:
        raise ValueError(f"{src.shape[0]} source rows for a plan of "
                         f"{plan.perm.shape[0]}")
    if rows is not None and plan.dest is None:
        raise ValueError("rows is given for a compact plan only")


def _place(sums: torch.Tensor, plan: SegmentPlan, rows) -> torch.Tensor:
    """A compact plan's segment sums at their rows of a ``[rows, C]``
    zero matrix (unique indices: no accumulation); with ``rows`` None the
    segment sums as they are."""
    if rows is None:
        return sums
    out = sums.new_zeros((rows + sums.shape[0], sums.shape[1]))
    return out.index_copy_(0, plan.dest, sums)[:rows]


def segment_sum_ref(src: torch.Tensor, plan: SegmentPlan,
                    rows: Optional[int] = None) -> torch.Tensor:
    """The plain version: the sources in ``perm``'s order, each segment
    folded from +0.0 one float32 add at a time by ``torch.segment_reduce``
    over ``offsets`` (a loop over each segment's sources in order; sources
    past the last offset, the padding, are not read). ``[n_seg, C]``, or
    ``[rows, C]`` placed by a compact plan's ``dest``. No host read."""
    _check(src, plan, rows)
    sums = torch.segment_reduce(src.index_select(0, plan.perm), "sum",
                                offsets=plan.offsets, unsafe=True)
    return _place(sums, plan, rows)


def _device_counter(dev: torch.device) -> torch.Tensor:
    counts = _DEVICE_COUNTS.get(dev.index)
    if counts is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("segment_sum: the launch counter must exist "
                               "before a CUDA graph capture (an eager call "
                               "makes it)")
        counts = _DEVICE_COUNTS[dev.index] = torch.zeros(
            1, dtype=torch.int64, device=dev)
    return counts


def device_launch_count(device=None) -> int:
    """The kernel's runs on ``device`` (default: the current CUDA device)
    as its device counter holds them: a host read."""
    dev = torch.device(device if device is not None else "cuda")
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    counts = _DEVICE_COUNTS.get(index)
    return 0 if counts is None else int(counts[0])


def reset_launches() -> None:
    """Set the wrapper's and the devices' counts to 0."""
    global launches
    launches = 0
    for counts in _DEVICE_COUNTS.values():
        counts.zero_()


def _segment_sum_cuda(src: torch.Tensor, plan: SegmentPlan,
                      rows: Optional[int]) -> torch.Tensor:
    global launches
    from cslam_tpu_torch.ops.nns import _lib_fn
    _check(src, plan, rows)
    dev = src.device
    perm, offsets = plan.perm, plan.offsets
    for name, t in (("perm", perm), ("offsets", offsets)):
        if t.device != dev or t.dtype != torch.int64 or \
                not t.is_contiguous():
            raise ValueError(f"segment_sum: {name} must be a contiguous "
                             f"int64 tensor on {dev}")
    src = src.contiguous()
    n_seg, C = offsets.shape[0] - 1, src.shape[1]
    out = torch.empty((n_seg, C), dtype=torch.float32, device=dev)
    if n_seg and C:
        with torch.cuda.device(dev):
            rc = _lib_fn("segment_sum", "cslam_segment_sum")(
                src.data_ptr(), perm.data_ptr(), offsets.data_ptr(),
                out.data_ptr(), n_seg, C, _device_counter(dev).data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"cslam_segment_sum launch failed: "
                               f"cudaError {rc}")
        launches += 1
    return _place(out, plan, rows)


def segment_sum(src: torch.Tensor, plan: SegmentPlan,
                rows: Optional[int] = None) -> torch.Tensor:
    """Sum the rows of ``src`` ``[n_src, C]`` float32 into segments in
    ``plan``'s order: ``[n_seg, C]``, or with ``rows`` a compact plan's
    sums placed in ``[rows, C]`` (see the module note). CPU tensors take
    :func:`segment_sum_ref`; CUDA tensors launch the kernel or raise."""
    if src.device.type == "cpu":
        return segment_sum_ref(src, plan, rows)
    if src.device.type != "cuda":
        raise ValueError(f"no segment sum for device {src.device}")
    return _segment_sum_cuda(src, plan, rows)
