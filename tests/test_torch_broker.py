"""Broker tests: vertex-cover invariants on end-to-end select->broker runs.

Same invariants as the reference suite (reference tests/test_broker.py): no
duplicate vertices, every selected edge covered, never worse than the trivial
one-vertex-per-edge solution, <= ceil(V/2) for the bipartite exact cover, and
a hand-built worked example with exact expected counts.

The port's mirror of ``tests/test_broker.py``: ``cslam_tpu_torch/selection/
broker.py`` is the JAX package's module with the port's imports, so the
same cases hold it, port only, the selections made by the port's
``LoopClosureSparseMatching`` on the CPU from the same seeded graphs
(``helpers.multi_robot_graph``'s, built from the port's edge records).
"""
import functools
import math

import pytest

from cslam_tpu_torch.selection.broker import Broker
from cslam_tpu_torch.matching.sparse_matching import LoopClosureSparseMatching
from cslam_tpu_torch.types import EdgeInterRobot

import helpers
from helpers import matching_params
from torch_threads import one_torch_thread  # noqa: F401


def multi_robot_graph(*args, **kwargs):
    """``helpers.multi_robot_graph`` in the port's edge records."""
    return tuple([EdgeInterRobot(*e) for e in edges]
                 for edges in helpers.multi_robot_graph(*args, **kwargs))


@functools.lru_cache(maxsize=None)
def select_edges(nb_poses, nb_candidates, nb_robots, robot_id, budget,
                 seed=None):
    """The port's selection on one seeded graph, made once for both of a
    case's ``use_vertex_cover`` flags (the broker copies it)."""
    fixed, candidates = multi_robot_graph(nb_poses, nb_candidates, nb_robots,
                                          seed=seed)
    lcsm = LoopClosureSparseMatching(
        matching_params(robot_id=robot_id, max_nb_robots=nb_robots),
        device="cpu")
    lcsm.candidate_selector.set_graph(fixed, candidates)
    considered = {i: True for i in range(nb_robots)}
    return tuple(lcsm.select_candidates(budget, considered,
                                        greedy_initialization=False))


def check_broker_invariants(nb_poses, nb_candidates, nb_robots, robot_id,
                            budget, use_vertex_cover, seed=None):
    selection = select_edges(nb_poses, nb_candidates, nb_robots, robot_id,
                             budget, seed=seed)
    assert len(selection) == min(nb_candidates, budget)

    broker = Broker(selection, list(range(nb_robots)))
    components = broker.brokerage(use_vertex_cover)

    initial_vertices = set()
    duplicates = []
    for e in selection:
        for v in [(e.robot0_id, e.robot0_keyframe_id),
                  (e.robot1_id, e.robot1_keyframe_id)]:
            if v in initial_vertices:
                duplicates.append(v)
            initial_vertices.add(v)
    assert len(initial_vertices) + len(duplicates) == 2 * len(selection)

    vertices = [v for comp in components for v in comp]

    # upper bounds: never worse than one vertex per edge
    assert len(vertices) <= min(nb_candidates, budget)
    if use_vertex_cover and nb_robots == 2:
        assert len(vertices) <= math.ceil(len(initial_vertices) / 2)
    assert len(vertices) >= 1

    # no duplicates
    assert len(vertices) == len(set(vertices))

    # every edge covered
    for e in selection:
        v0 = (e.robot0_id, e.robot0_keyframe_id)
        v1 = (e.robot1_id, e.robot1_keyframe_id)
        assert v0 in vertices or v1 in vertices


# the reference suite's cases but its 5-robot 1,000-pose one (MAC's
# Woodbury tier at 5,000 poses, about 160 s on the CPU); the two 1,000-pose
# cases here take the Woodbury tier too
CASES_2R = [
    (100, 50, 2, 0, 30),
    (100, 50, 2, 0, 50),
    (1000, 500, 2, 0, 300),
    (1000, 500, 2, 0, 500),
    (100, 50, 2, 0, 100),
]

CASES_5R = [
    (100, 200, 5, 1, 100),
    (100, 200, 5, 1, 200),
    (100, 200, 5, 2, 400),
]


@pytest.mark.parametrize("case", CASES_2R)
@pytest.mark.parametrize("use_vertex_cover", [False, True])
def test_broker_2robots(case, use_vertex_cover):
    check_broker_invariants(*case, use_vertex_cover, seed=hash(case) % 1000)


@pytest.mark.parametrize("case", CASES_5R)
@pytest.mark.parametrize("use_vertex_cover", [False, True])
def test_broker_5robots(case, use_vertex_cover):
    check_broker_invariants(*case, use_vertex_cover, seed=hash(case) % 1000)


def test_manual_vertex_cover():
    """Worked example (reference tests/test_broker.py:213-265): a star from
    (0,1) to four robot-1 keyframes plus one extra edge -> 2 components,
    2 vertices total."""
    candidates = [
        EdgeInterRobot(0, 1, 1, 1, 1.0),
        EdgeInterRobot(0, 1, 1, 2, 1.0),
        EdgeInterRobot(0, 1, 1, 3, 1.0),
        EdgeInterRobot(0, 1, 1, 4, 1.0),
        EdgeInterRobot(0, 2, 1, 5, 1.0),
    ]
    lcsm = LoopClosureSparseMatching(matching_params(max_nb_robots=2),
                                     device="cpu")
    lcsm.candidate_selector.set_graph([], candidates)
    selection = lcsm.select_candidates(5, {0: True, 1: True},
                                       greedy_initialization=False)
    assert len(selection) == 5

    broker = Broker(selection, range(2))
    components = broker.brokerage(True)
    assert len(components) == 2
    assert sum(len(c) for c in components) == 2


def test_broker_single_robot_graph_is_empty():
    broker = Broker([EdgeInterRobot(0, 1, 0, 2, 1.0)], [0])
    assert broker.brokerage(True) == []
