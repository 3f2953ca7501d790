"""Sparse inter-robot loop-closure matching over descriptor banks.

Counterpart of ``cslam_tpu/matching/sparse_matching.py`` (reference
``cslam/loop_closure_sparse_matching.py``): one local descriptor bank plus
one bank per other robot; every new descriptor is searched against the
other side's banks and similarity hits above the threshold become candidate
edges for the budgeted selector.

A lidar configuration (``frontend.sensor_type: lidar``) keeps Scan Context
banks (``matching.scancontext_bank``): every other robot's bank is searched
for a local keyframe in one multi-bank search, and a gossip chunk in one
batched two-stage search of the local bank.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from cslam_tpu_torch import resolve_device
from cslam_tpu_torch.matching.nns_bank import DescriptorBank
from cslam_tpu_torch.matching.scancontext_bank import (
    ScanContextBank, multi_search_best_begin, multi_search_best_finish)
from cslam_tpu_torch.ops import topk as topk_ops
from cslam_tpu_torch.selection.acm import AlgebraicConnectivityMaximization
from cslam_tpu_torch.types import EdgeInterRobot
from cslam_tpu_torch.utils import device_read


class SearchHandle:
    """Pending device results of a dispatched cross-bank search.

    ``hits`` carries results already resolved at dispatch time (blocking
    sub-paths); ``parts`` the deferred device results. ``arrays`` exposes
    every pending device tensor so a harvest point can
    ``device_read.prefetch`` across several handles before finishing them
    one by one.
    """

    __slots__ = ("lcm", "keyframe_id", "hits", "parts", "msgs")

    def __init__(self, lcm, keyframe_id, hits, parts):
        self.lcm, self.keyframe_id = lcm, keyframe_id
        self.hits, self.parts = hits, parts
        self.msgs = []

    @property
    def arrays(self):
        out = []
        for kind, _, payload in self.parts:
            if kind in ("sc", "sc_batch"):
                out.extend(payload.arrays)
            else:
                out.extend(payload)
        return out


def _make_bank(params: dict, device):
    if params.get("frontend.sensor_type") == "lidar":
        return ScanContextBank(
            capacity=params.get("frontend.bank_initial_capacity", 1024),
            fused_stage1=params.get(
                "frontend.scancontext_fused_stage1", False),
            device=device)
    return DescriptorBank(
        capacity=params.get("frontend.bank_initial_capacity", 1024),
        dtype=params.get("frontend.nns_bank_dtype", "float32"),
        device=device)


class LoopClosureSparseMatching:
    """Matches global descriptors into budget-selected loop-closure
    candidates. Runs on the CUDA device unless ``device`` says otherwise."""

    def __init__(self, params: dict, device=None):
        self.params = params
        self.device = resolve_device(device)
        self.local_nnsm = _make_bank(params, self.device)
        self.other_robots_nnsm: Dict[int, Any] = {}
        for i in range(params["max_nb_robots"]):
            if i != params["robot_id"]:
                self.other_robots_nnsm[i] = _make_bank(params, self.device)
        self.candidate_selector = AlgebraicConnectivityMaximization(
            params["robot_id"], params["max_nb_robots"],
            max_iters=int(params.get("frontend.mac_max_iters", 20)),
            extra_params=params, device=self.device)

    # banks up to this capacity are stacked and searched in ONE dispatch;
    # beyond it, restacking R banks per keyframe costs more memory traffic
    # than the saved dispatches, so each falls back to its own bank scan
    _MULTI_SEARCH_MAX_CAPACITY = 16384

    def add_local_global_descriptor(self, embedding: np.ndarray,
                                    keyframe_id: int) -> List[EdgeInterRobot]:
        """Store a local keyframe descriptor and match it against every other
        robot's bank (reference lcsm.py:36-54)."""
        return self.add_local_global_descriptor_finish(
            self.add_local_global_descriptor_begin(embedding, keyframe_id))

    def add_local_global_descriptor_begin(self, embedding: np.ndarray,
                                          keyframe_id: int) -> "SearchHandle":
        """Store the descriptor and DISPATCH the cross-bank searches without
        blocking on their results; :meth:`add_local_global_descriptor_finish`
        resolves the handle to the match list."""
        self.local_nnsm.add_item(embedding, keyframe_id)
        hits: List[Tuple[int, Any, float]] = []
        groups: Dict[int, list] = {}
        sc_banks: List[Tuple[int, Any]] = []
        for rid, bank in self.other_robots_nnsm.items():
            if isinstance(bank, ScanContextBank):
                sc_banks.append((rid, bank))
            elif (bank.n > 0
                  and bank.capacity <= self._MULTI_SEARCH_MAX_CAPACITY):
                groups.setdefault(bank.capacity, []).append((rid, bank))
            else:
                kf, similarity = bank.search_best(embedding)
                if kf is not None:
                    hits.append((rid, kf, similarity))
        parts = []
        if sc_banks:
            # scan-context banks: every other robot's in one search
            parts.append(("sc", [rid for rid, _ in sc_banks],
                          multi_search_best_begin(
                              [b for _, b in sc_banks], embedding)))
        if groups:
            q = torch.from_numpy(np.asarray(embedding, np.float32)).to(
                self.device)
            for members in groups.values():
                for _, b in members:
                    b._sync_device()
                banks = torch.stack([b._bank for _, b in members])
                invn = torch.stack([b._inv_norms for _, b in members])
                ns = torch.tensor([b.n for _, b in members],
                                  device=self.device)
                sims, idx = topk_ops.cosine_top1_multi(banks, invn, ns, q)
                device_read.prefetch((sims, idx))
                parts.append(("group", members, (sims, idx)))
        return SearchHandle(self, keyframe_id, hits, parts)

    def add_local_global_descriptor_finish(self, handle: "SearchHandle"
                                           ) -> List[EdgeInterRobot]:
        """Materialize a dispatched per-keyframe search: read results,
        threshold, and register candidate edges."""
        hits = list(handle.hits)
        for kind, meta, payload in handle.parts:
            if kind == "sc":
                for rid, (kf, similarity) in zip(
                        meta, multi_search_best_finish(payload)):
                    if kf is not None:
                        hits.append((rid, kf, similarity))
                continue
            sims, idx = (device_read.to_numpy(payload[0]),
                         device_read.to_numpy(payload[1]))
            for (rid, b), s, i in zip(meta, sims, idx):
                hits.append((rid, b.items[int(i)], float(s)))
        matches = []
        for rid, kf, similarity in sorted(hits):
            if similarity >= self.params["frontend.similarity_threshold"]:
                match = EdgeInterRobot(
                    self.params["robot_id"], handle.keyframe_id,
                    rid, kf, similarity)
                self.candidate_selector.add_match(match)
                matches.append(match)
        return matches

    def add_other_robot_global_descriptor(self, msg) -> Optional[EdgeInterRobot]:
        """Intake a gossiped descriptor from another robot and match it
        against the local bank (reference lcsm.py:56-72)."""
        self.other_robots_nnsm[msg.robot_id].add_item(
            np.asarray(msg.descriptor), msg.keyframe_id)
        kf, similarity = self.local_nnsm.search_best(np.asarray(msg.descriptor))
        if kf is None:
            return None
        if similarity < self.params["frontend.similarity_threshold"]:
            return None
        match = EdgeInterRobot(self.params["robot_id"], kf, msg.robot_id,
                               msg.keyframe_id, similarity)
        self.candidate_selector.add_match(match)
        return match

    def add_other_robot_global_descriptors(self, msgs) -> List[EdgeInterRobot]:
        """Batched gossip intake: one bank search for a whole descriptor
        chunk (result-identical to calling
        :meth:`add_other_robot_global_descriptor` per message)."""
        return self.add_other_robot_global_descriptors_finish(
            self.add_other_robot_global_descriptors_begin(msgs))

    def add_other_robot_global_descriptors_begin(self, msgs
                                                 ) -> "SearchHandle":
        """Intake the chunk into sender banks and DISPATCH the local-bank
        search without blocking."""
        msgs = list(msgs)
        handle = SearchHandle(self, None, [], [])
        handle.msgs = msgs
        if not msgs:
            return handle
        for m in msgs:
            self.other_robots_nnsm[m.robot_id].add_item(
                np.asarray(m.descriptor), m.keyframe_id)
        if self.local_nnsm.n == 0:
            return handle
        queries = np.stack([np.asarray(m.descriptor, np.float32).ravel()
                            for m in msgs])
        if isinstance(self.local_nnsm, ScanContextBank):
            handle.parts.append(
                ("sc_batch", None,
                 self.local_nnsm.search_best_batch_begin(queries)))
            return handle
        sims, idx = self.local_nnsm.search_batch_begin(queries, k=1)
        handle.parts.append(("bank_batch", None, (sims, idx)))
        return handle

    def add_other_robot_global_descriptors_finish(self, handle: "SearchHandle"
                                                  ) -> List[EdgeInterRobot]:
        """Materialize a dispatched gossip-chunk search: read, threshold,
        register candidate edges."""
        if not handle.parts:
            return []
        kind, _, payload = handle.parts[0]
        if kind == "sc_batch":
            best = self.local_nnsm.search_best_batch_finish(payload)
        else:
            sims = device_read.to_numpy(payload[0])
            idx = device_read.to_numpy(payload[1])
            best = [(self.local_nnsm.items[int(i)], float(s))
                    for s, i in zip(sims[:, 0], idx[:, 0])]
        matches = []
        threshold = self.params["frontend.similarity_threshold"]
        for m, (kf, s) in zip(handle.msgs, best):
            if kf is None or s < threshold:
                continue
            match = EdgeInterRobot(self.params["robot_id"], kf,
                                   m.robot_id, m.keyframe_id, float(s))
            self.candidate_selector.add_match(match)
            matches.append(match)
        return matches

    def match_local_loop_closures(
            self, descriptor: np.ndarray,
            kf_id: int) -> Tuple[Optional[int], Optional[List[int]]]:
        """Best intra-robot loop-closure match with a minimum keyframe gap
        (reference lcsm.py:74-92)."""
        kfs, similarities = self.local_nnsm.search(
            descriptor, k=self.params["frontend.nb_best_matches"])
        if len(kfs) > 0 and kfs[0] == kf_id:
            kfs, similarities = kfs[1:], similarities[1:]
        if len(kfs) == 0 or kfs[0] is None:
            return None, None
        gap = self.params["frontend.intra_loop_min_inbetween_keyframes"]
        for kf, similarity in zip(kfs, similarities):
            if abs(kf - kf_id) < gap:
                continue
            if similarity < self.params["frontend.similarity_threshold"]:
                continue
            return kf, kfs
        return None, None

    def select_candidates_begin(self, number_of_candidates: int,
                                is_other_robot_considered):
        """Dispatch a selection round (see ACM.select_candidates_begin)."""
        return self.candidate_selector.select_candidates_begin(
            number_of_candidates, is_other_robot_considered)

    def select_candidates_finish(self, handle):
        """Materialize a dispatched selection round."""
        return self.candidate_selector.select_candidates_finish(handle)

    def select_candidates(self, number_of_candidates: int,
                          is_neighbor_in_range: Dict[int, bool],
                          greedy_initialization: bool = True
                          ) -> List[EdgeInterRobot]:
        """Budgeted selection delegated to the ACM/MAC stack."""
        return self.candidate_selector.select_candidates(
            number_of_candidates, is_neighbor_in_range, greedy_initialization)
