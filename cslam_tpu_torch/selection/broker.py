"""Communication broker: pick which keyframe vertices to transmit.

Equivalent of the reference ``cslam/broker.py``: given the selected
inter-robot edges and the robots in range, choose a minimal set of keyframe
*vertices* whose local data must be sent so every selected edge can be
geometrically verified. Per connected component:

- exactly 2 robots involved  -> exact minimum vertex cover via maximum
  bipartite matching + König's theorem (reference broker.py:101-105),
- more than 2 robots         -> 2-approximate local-ratio min weighted vertex
  cover (reference broker.py:107-109),
- fallback "simple dialog"   -> one random endpoint per uncovered edge
  (reference broker.py:112-129).

Pure host code (graphs are tiny and per-round); the graph primitives live in
``cslam_tpu.graphs`` instead of networkx.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Set, Tuple

import numpy as np

from cslam_tpu_torch import graphs
from cslam_tpu_torch.types import EdgeInterRobot

Vertex = Tuple[int, int]  # (robot_id, keyframe_id)


class Broker:
    """Decides which matching-graph vertices to share between robots."""

    def __init__(self, edges: Sequence[EdgeInterRobot],
                 robots_involved: Sequence[int]):
        self.edges = list(edges)
        involved: Set[int] = set()
        for e in self.edges:
            if e.robot0_id in robots_involved:
                involved.add(e.robot0_id)
            if e.robot1_id in robots_involved:
                involved.add(e.robot1_id)
        self._robots_with_edges = sorted(involved)
        self.is_multi_robot_graph = len(self._robots_with_edges) >= 2
        self.is_bipartite = len(self._robots_with_edges) == 2

        self._adj: Dict[Vertex, Set[Vertex]] = {}
        if self.is_multi_robot_graph:
            ok = set(self._robots_with_edges)
            for e in self.edges:
                v0 = (e.robot0_id, e.robot0_keyframe_id)
                v1 = (e.robot1_id, e.robot1_keyframe_id)
                if v0[0] in ok and v1[0] in ok:
                    self._adj.setdefault(v0, set()).add(v1)
                    self._adj.setdefault(v1, set()).add(v0)

    def brokerage(self, use_vertex_cover: bool) -> List[Set[Vertex]]:
        """Vertex sets to transmit, one per connected component."""
        if not self.is_multi_robot_graph:
            return []
        return self.vertex_cover() if use_vertex_cover else self.simple_dialog()

    def vertex_cover(self) -> List[Set[Vertex]]:
        """Minimum (or 2-approximate) vertex cover per connected component."""
        covers: List[Set[Vertex]] = []
        for comp in graphs.connected_components(self._adj):
            sub = {v: self._adj[v] & comp for v in comp}
            if self.is_bipartite:
                side0 = {v for v in comp if v[0] == self._robots_with_edges[0]}
                side1 = comp - side0
                covers.append(graphs.konig_vertex_cover(side0, side1, sub))
            else:
                covers.append(graphs.local_ratio_vertex_cover(sub))
        return covers

    def simple_dialog(self) -> List[Set[Vertex]]:
        """One random endpoint per edge unless already covered."""
        chosen: Set[Vertex] = set()
        for e in self.edges:
            v = [(e.robot0_id, e.robot0_keyframe_id),
                 (e.robot1_id, e.robot1_keyframe_id)]
            if v[0] not in chosen and v[1] not in chosen:
                chosen.add(v[int(np.random.randint(2))])
        return [chosen]
