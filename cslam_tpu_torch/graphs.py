"""Self-contained host-side graph algorithms.

The reference delegates these to networkx (``cslam/broker.py:84-110`` uses
bipartite maximum matching + König vertex-cover recovery and the local-ratio
approximate min weighted vertex cover; connectivity checks use
``nx.connected_components``). Here they are implemented from scratch so the
framework has no graph-library dependency; they run on the host because the
graphs involved are tiny (tens to hundreds of selected edges per detection
round) and inherently dynamic.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, Hashable, Iterable, List, Sequence, Set, Tuple

Vertex = Hashable


def adjacency(edges: Iterable[Tuple[Vertex, Vertex]]) -> Dict[Vertex, Set[Vertex]]:
    adj: Dict[Vertex, Set[Vertex]] = {}
    for u, v in edges:
        adj.setdefault(u, set()).add(v)
        adj.setdefault(v, set()).add(u)
    return adj


def connected_components(adj: Dict[Vertex, Set[Vertex]]) -> List[Set[Vertex]]:
    """Connected components via BFS."""
    seen: Set[Vertex] = set()
    components: List[Set[Vertex]] = []
    for start in adj:
        if start in seen:
            continue
        comp: Set[Vertex] = set()
        queue = deque([start])
        seen.add(start)
        while queue:
            u = queue.popleft()
            comp.add(u)
            for v in adj[u]:
                if v not in seen:
                    seen.add(v)
                    queue.append(v)
        components.append(comp)
    return components


def hopcroft_karp(left: Sequence[Vertex],
                  adj: Dict[Vertex, Set[Vertex]]) -> Dict[Vertex, Vertex]:
    """Maximum bipartite matching (Hopcroft–Karp).

    Args:
        left: vertices of the left part.
        adj: adjacency restricted to edges from left to right vertices.

    Returns:
        matching as a dict containing both directions (u->v and v->u).
    """
    INF = float("inf")
    match_l: Dict[Vertex, Vertex] = {}
    match_r: Dict[Vertex, Vertex] = {}
    dist: Dict[Vertex, float] = {}

    def bfs() -> bool:
        queue: deque = deque()
        for u in left:
            if u not in match_l:
                dist[u] = 0
                queue.append(u)
            else:
                dist[u] = INF
        found = False
        while queue:
            u = queue.popleft()
            for v in adj.get(u, ()):
                w = match_r.get(v)
                if w is None:
                    found = True
                elif dist.get(w, INF) == INF:
                    dist[w] = dist[u] + 1
                    queue.append(w)
        return found

    def dfs(u: Vertex) -> bool:
        for v in adj.get(u, ()):
            w = match_r.get(v)
            if w is None or (dist.get(w) == dist[u] + 1 and dfs(w)):
                match_l[u] = v
                match_r[v] = u
                return True
        dist[u] = INF
        return False

    while bfs():
        for u in list(left):
            if u not in match_l:
                dfs(u)

    matching: Dict[Vertex, Vertex] = {}
    matching.update(match_l)
    matching.update(match_r)
    return matching


def konig_vertex_cover(left: Set[Vertex], right: Set[Vertex],
                       adj: Dict[Vertex, Set[Vertex]]) -> Set[Vertex]:
    """Minimum vertex cover of a bipartite graph via König's theorem.

    Matches the reference's ``nx.bipartite.to_vertex_cover`` usage
    (``cslam/broker.py:103-105``): compute a maximum matching, then
    Z = vertices reachable from unmatched left vertices by alternating paths;
    the cover is (L \\ Z) ∪ (R ∩ Z).
    """
    matching = hopcroft_karp(sorted(left, key=repr), {
        u: {v for v in adj.get(u, ()) if v in right} for u in left})
    unmatched_left = {u for u in left if u not in matching}
    z: Set[Vertex] = set(unmatched_left)
    queue = deque(unmatched_left)
    # alternate: left -> right along NON-matching edges, right -> left along
    # matching edges
    while queue:
        u = queue.popleft()
        if u in left:
            for v in adj.get(u, ()):
                if matching.get(u) != v and v not in z:
                    z.add(v)
                    queue.append(v)
        else:
            w = matching.get(u)
            if w is not None and w not in z:
                z.add(w)
                queue.append(w)
    return (left - z) | (right & z)


def local_ratio_vertex_cover(adj: Dict[Vertex, Set[Vertex]],
                             weights: Dict[Vertex, float] | None = None
                             ) -> Set[Vertex]:
    """2-approximate min weighted vertex cover (Bar-Yehuda & Even local ratio).

    Same algorithm as networkx's ``min_weighted_vertex_cover`` used for the
    non-bipartite broker case (reference ``cslam/broker.py:107-109``).
    """
    cost: Dict[Vertex, float] = {
        v: (weights.get(v, 1.0) if weights else 1.0) for v in adj}
    cover: Set[Vertex] = set()
    seen: Set[Tuple[Vertex, Vertex]] = set()
    for u in adj:
        for v in adj[u]:
            if (v, u) in seen:
                continue  # visit each undirected edge once
            seen.add((u, v))
            if u in cover or v in cover:
                continue
            # take the cheaper endpoint into the cover; charge the other
            if cost[u] <= cost[v]:
                cover.add(u)
                cost[v] -= cost[u]
            else:
                cover.add(v)
                cost[u] -= cost[v]
    return cover


def bfs_reachable(start: Vertex,
                  neighbors: Dict[Vertex, Iterable[Vertex]]) -> Set[Vertex]:
    """Vertices reachable from ``start`` following ``neighbors`` lists.

    Mirrors the connectivity BFS the back end runs over received pose-graph
    connectivity (reference ``src/back_end/decentralized_pgo.cpp:464-508``).
    Note the reference marks every *listed* neighbor as connected even if it
    never sent a graph; callers replicate that by post-processing.
    """
    seen: Set[Vertex] = {start}
    queue = deque([start])
    while queue:
        u = queue.popleft()
        for v in neighbors.get(u, ()):
            if v not in seen:
                seen.add(v)
                queue.append(v)
    return seen
