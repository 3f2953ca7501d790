"""Fixed-capacity descriptor bank with device-side batched cosine top-k.

Counterpart of ``cslam_tpu/matching/nns_bank.py`` (the reference's
``NearestNeighborsMatching``): same duck-typed ``add_item / search /
search_best`` interface.

Design notes:
- Host numpy storage is the source of truth; appends are O(1). The device
  mirror is synchronized lazily right before a search, so the per-keyframe
  ingest path never blocks on device transfers. The mirror stores UNIT rows
  (``inv_norms`` stays all-ones), so the bank scan needs no per-search
  normalization pass.
- Capacity doubles when full (the reference doubles too).
- Search dispatch: a CUDA bank with ``k <= MAX_K`` goes through the
  hand-written bank-scan kernel (``ops.nns``); a CPU bank through its plain
  version; a CUDA bank with a larger ``k`` through the plain matmul top-k.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from cslam_tpu_torch import resolve_device
from cslam_tpu_torch.ops import nns
from cslam_tpu_torch.ops import topk as topk_ops

_DEFAULT_CAPACITY = 1024


def _k_bucket(k: int) -> int:
    """Round k up to a power of two."""
    b = 1
    while b < k:
        b *= 2
    return b


class DescriptorBank:
    """Growable bank of global descriptors with cosine top-k search."""

    def __init__(self, dim: Optional[int] = None,
                 capacity: int = _DEFAULT_CAPACITY,
                 dtype: str = "float32", device=None):
        self.n = 0
        self.dim = dim
        self.items: Dict[int, Any] = {}
        self._capacity = capacity
        self._host: Optional[np.ndarray] = None
        if dim is not None:
            self._host = np.zeros((capacity, dim), dtype=np.float32)
        self.device = resolve_device(device)
        # device mirror; host storage stays f32 (source of truth), the
        # mirror optionally stores bfloat16 unit rows — halves the bank
        # scan's memory traffic at ~4e-3 relative similarity error
        self._dtype = (torch.bfloat16 if dtype == "bfloat16"
                       else torch.float32)
        self._bank: Optional[torch.Tensor] = None
        self._inv_norms: Optional[torch.Tensor] = None
        self._device_n = 0

    @property
    def capacity(self) -> int:
        return self._capacity

    # -- reference-compatible alias: NearestNeighborsMatching exposed `.data`
    @property
    def data(self) -> np.ndarray:
        if self._host is None:
            return np.zeros((0, 0), dtype=np.float32)
        return self._host

    def add_item(self, vector: np.ndarray, item: Any) -> None:
        """Append one descriptor with its identification info."""
        vector = np.asarray(vector, dtype=np.float32)
        assert vector.ndim == 1
        if self.dim is None:
            self.dim = int(vector.shape[0])
            self._host = np.zeros((self._capacity, self.dim), dtype=np.float32)
        if self.n >= self._capacity:
            self._grow()
        self._host[self.n] = vector
        self.items[self.n] = item
        self.n += 1

    def add_items(self, vectors: np.ndarray, items: List[Any]) -> None:
        """Bulk append (used by gossip intake and benchmarks)."""
        vectors = np.asarray(vectors, dtype=np.float32)
        if self.dim is None:
            self.dim = int(vectors.shape[1])
            self._host = np.zeros((self._capacity, self.dim), dtype=np.float32)
        while self.n + len(vectors) > self._capacity:
            self._grow()
        self._host[self.n:self.n + len(vectors)] = vectors
        for i, it in enumerate(items):
            self.items[self.n + i] = it
        self.n += len(vectors)

    def _grow(self) -> None:
        self._capacity *= 2
        new = np.zeros((self._capacity, self.dim), dtype=np.float32)
        new[:self.n] = self._host[:self.n]
        self._host = new
        self._bank = None  # force device re-upload at next search
        self._device_n = 0

    def _sync_device(self) -> None:
        """Upload the rows appended since the last sync as unit rows, in
        place. (The JAX original wrote fixed 256-row chunks so that one
        compiled program served every delta; eager PyTorch compiles
        nothing, so the delta is written as it is.)"""
        if self._bank is None:
            self._bank = torch.zeros((self._capacity, self.dim),
                                     dtype=self._dtype, device=self.device)
            self._inv_norms = torch.ones((self._capacity,),
                                         dtype=torch.float32,
                                         device=self.device)
            self._device_n = 0
        if self._device_n < self.n:
            rows = torch.from_numpy(
                self._host[self._device_n:self.n]).to(self.device)
            topk_ops.update_rows_unit(self._bank, rows, self._device_n)
            self._device_n = self.n

    # ------------------------------------------------------------------
    # Search
    # ------------------------------------------------------------------

    def search(self, query: np.ndarray, k: int) -> Tuple[List[Any], np.ndarray]:
        """Best-k matches of one query, sorted by descending cosine
        similarity (reference ``nns_matching.py:42-61``)."""
        if self.n == 0 or self._host is None:
            return [], np.zeros((0,))
        sims, idx = self.search_batch(np.asarray(query)[None, :], k)
        kk = min(k, self.n)
        return ([self.items[int(i)] for i in idx[0][:kk]],
                np.asarray(sims[0][:kk]))

    def search_best(self, query: np.ndarray) -> Tuple[Any, Optional[float]]:
        """Single nearest neighbor (reference ``nns_matching.py:63-76``)."""
        if self.n == 0:
            return None, None
        items, sims = self.search(query, 1)
        return items[0], float(sims[0])

    def search_batch(self, queries: np.ndarray,
                     k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Batched top-k over the bank: ``[B, dim] -> ([B, k], [B, k])``
        host arrays; entries beyond ``self.n`` valid rows have similarity
        ``-inf``."""
        b = len(queries)
        sims, idx = self.search_batch_begin(queries, k)
        return (sims[:b, :k].cpu().numpy(), idx[:b, :k].cpu().numpy())

    def search_batch_begin(self, queries: np.ndarray, k: int):
        """Dispatch :meth:`search_batch` without blocking on the result:
        returns ``(sims, idx)`` device tensors with AT LEAST ``k`` columns
        and AT LEAST ``len(queries)`` rows (batches are zero-padded to a
        power of two; callers index rows by their own query count).
        Harvest with ``utils.device_read.fetch``."""
        self._sync_device()
        queries = np.asarray(queries, dtype=np.float32)
        b = _k_bucket(max(len(queries), 1))
        if b != len(queries):
            queries = np.concatenate(
                [queries, np.zeros((b - len(queries), queries.shape[1]),
                                   np.float32)])
        q = torch.from_numpy(queries).to(self.device)
        if self._use_bank_scan(k):
            return nns.cosine_topk_scan(self._bank, self.n, q, k)
        kb = min(_k_bucket(k), self._capacity)
        return topk_ops.cosine_topk(self._bank, self._inv_norms, self.n, q, kb)

    def _use_bank_scan(self, k: int) -> bool:
        """The bank scan (kernel on the card, plain version on the CPU)
        serves every k it takes; the TPU's capacity % TILE_N condition is
        gone."""
        return k <= nns.MAX_K


def warmup_bank_tiers(capacity: int, dim: int,
                      batch_tiers=(1, 2, 4, 8, 16, 32),
                      multi_bank_counts=(),
                      k_values=(1, 10), device=None) -> None:
    """Exercise every device path the visual-descriptor bank hits at one
    capacity: the append, the (batch, k) search grid and the stacked
    multi-bank top-1. Eager PyTorch compiles nothing per shape, so what
    this warms is the one-time work: the bank-scan kernel's build and load
    on the card, and the CUDA context and library handles."""
    rng = np.random.default_rng(0)
    bank = DescriptorBank(dim=dim, capacity=capacity, device=device)
    for round_ in range(2):
        bank.add_item(rng.standard_normal(dim).astype(np.float32), round_)
        for b in batch_tiers:
            q = rng.standard_normal((b, dim)).astype(np.float32)
            for k in k_values:
                sims, idx = bank.search_batch_begin(q, k)
                sims.cpu()
    for r in multi_bank_counts:
        if r < 1:
            continue
        bank._sync_device()
        banks = torch.stack([bank._bank] * r)
        invn = torch.stack([bank._inv_norms] * r)
        ns = torch.tensor([bank.n] * r, device=bank.device)
        for fill in (0.0, 0.25):
            q = torch.full((dim,), fill, device=bank.device)
            sims, idx = topk_ops.cosine_top1_multi(banks, invn, ns, q)
            sims.cpu()
