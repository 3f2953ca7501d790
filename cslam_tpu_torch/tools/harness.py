"""What the scale tools share: the card line, device syncs, the mission
loop of ``benchmarks/{lidar,visual}_e2e_scale_bench.py`` (its drifting
tracks, its config pins, its warmups and its report) and the counters that
say whether a mission captured a CUDA graph after its warmup.

``tools/lidar_e2e_scale.py`` and ``tools/visual_e2e_scale.py`` build their
sensor's nodes and world and hand them to :func:`run_nodes`; ``chip_smoke.py``
calls those tools' ``run_mission``.
"""
from __future__ import annotations

import contextlib
import os
import subprocess
import time

import numpy as np


def card_line() -> str:
    """The card's ``nvidia-smi --query-gpu=name,power.limit`` line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "?"


def synchronize(device) -> None:
    """Wait for the card (no-op on the CPU), once no graph capture is in
    flight (``utils.tier_graphs.synchronize``)."""
    import torch
    if torch.device(device).type == "cuda":
        from cslam_tpu_torch.utils import tier_graphs
        tier_graphs.synchronize(device)


def timed(fn, device):
    """(result, seconds) of ``fn()``: CUDA events around it on the card
    (the port's solves end in host reads, so the end event follows their
    work), the host clock on the CPU."""
    import torch
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


# -- CUDA graph counters ------------------------------------------------------


def graph_sets():
    """Every graphed program set of the main path: the verification chunks
    (``TierGraphs``) and the solvers' step programs (``StepGraphs``)."""
    from cslam_tpu_torch.ops import registration as reg
    from cslam_tpu_torch.ops import visual_registration as vreg
    from cslam_tpu_torch.pgo import distributed, solver
    from cslam_tpu_torch.selection import mac
    return (reg.VERIFY_GRAPHS, vreg.ALIGN_GRAPHS, vreg.PNP_GRAPHS,
            solver.DENSE_GRAPHS, solver.PCG_GRAPHS,
            distributed.BATCHED_GRAPHS, distributed.BATCHED_PCG_GRAPHS,
            distributed.DIST_GRAPHS, mac.DENSE_FW_GRAPHS,
            mac.WOODBURY_FW_GRAPHS)


def graph_counts() -> dict:
    """{set: (captures, captures off the main thread, replays)}."""
    return {g.name: (g.captures, getattr(g, "captures_bg", 0), g.replays)
            for g in graph_sets()}


def graph_delta(before: dict) -> dict:
    """Captures and replays per set since ``before`` (a
    :func:`graph_counts`), and ``captures``: those made on the main
    thread, which a mission's warmup must leave at 0 (a MAC prefetch
    thread may capture the next tier in the background, ``captures_bg``,
    as the JAX package compiles it there)."""
    after = graph_counts()
    delta = {k: dict(zip(("captures", "captures_bg", "replays"),
                         (a - b for a, b in zip(after[k], before[k]))))
             for k in after}
    return {"by_set": delta,
            "captures": sum(d["captures"] - d["captures_bg"]
                            for d in delta.values()),
            "captures_bg": sum(d["captures_bg"] for d in delta.values()),
            "replays": sum(d["replays"] for d in delta.values())}


@contextlib.contextmanager
def dump_pgo(dump_dir):
    """``CSLAM_TPU_DUMP_PGO`` set to ``dump_dir`` inside (unchanged where
    ``dump_dir`` is None): the back end's dump hook."""
    if dump_dir is None:
        yield
        return
    saved = os.environ.get("CSLAM_TPU_DUMP_PGO")
    os.environ["CSLAM_TPU_DUMP_PGO"] = str(dump_dir)
    try:
        yield
    finally:
        if saved is None:
            del os.environ["CSLAM_TPU_DUMP_PGO"]
        else:
            os.environ["CSLAM_TPU_DUMP_PGO"] = saved


# -- the benches' mission ----------------------------------------------------


def pose_xyz_yaw(x, y, z=0.0, yaw=0.0) -> np.ndarray:
    T = np.eye(4)
    c, s = np.cos(yaw), np.sin(yaw)
    T[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    T[:3, 3] = [x, y, z]
    return T


def scene_grid(scenes: int) -> list:
    """The benches' world loop: scene ``s`` at (7 (s % 8), 7 (s // 8))."""
    return [pose_xyz_yaw(7.0 * (s % 8), 7.0 * (s // 8)) for s in range(scenes)]


def drift_tracks(robots, steps, scene_pose, offset, rng):
    """The benches' tracks: robot ``r`` visits scene ``(i + 5 r) % S`` at
    ``scene_pose[s] @ offset(r)``; its odometry composes the true steps
    with 5 cm of translation noise per step from ``rng``. Returns (truth:
    {r: [(scene, pose)]}, drifted: {r: [pose]})."""
    S = len(scene_pose)
    gt = {r: [] for r in range(robots)}
    drifted = {r: [] for r in range(robots)}
    for r in range(robots):
        cur = None
        for i in range(steps):
            s = (i + 5 * r) % S
            p = scene_pose[s] @ offset(r)
            gt[r].append((s, p))
            if cur is None:
                cur = p.copy()
            else:
                z = np.linalg.inv(gt[r][i - 1][1]) @ p
                z[:3, 3] += rng.normal(scale=0.05, size=3)
                cur = cur @ z
            drifted[r].append(cur.copy())
    return gt, drifted


def pin_config(cfg, pins: bool, sync: bool, mac_max_iters=None) -> None:
    """The settings both benches give every robot: detection and
    publication periods, the bounded candidate pool and the ready gate,
    the 30 s start of the back end, no neighbour monitoring; with ``pins``
    their tier floors (MAC's mf, P and E axes and PGO's pose and edge
    axes at 2,048: one MAC and one GNC tier for a 5 x 210 mission); with
    ``sync`` detection and verification in the caller's thread."""
    f = cfg.frontend
    f.inter_robot_detection_period_sec = 3.0
    f.detection_publication_period_sec = 1.0
    f.max_candidate_pool = 2048
    f.harvest_ready_gate = True
    if pins:
        f.mac_mf_floor = 2048
        f.mac_p_floor = 2048
        f.mac_e_floor = 2048
        cfg.backend.pgo_np_floor = 2048
        cfg.backend.pgo_ne_floor = 2048
    if sync:
        f.async_detection = False
        f.async_verification = False
    if mac_max_iters is not None:
        f.mac_max_iters = mac_max_iters
    cfg.backend.pose_graph_optimization_start_period_ms = 30000
    cfg.neighbor_management.enable_neighbor_monitoring = False


def warm_solvers(det, backend, robots, steps, device) -> None:
    """MAC's selection programs (every tier of
    ``selection_tier_grid(robots * steps, 2048)`` at the node's MAC
    keywords and FW cap) and the back end's GNC programs (its
    ``warmup_tier_grid(robots * steps, 2 * robots * steps)``: the elected
    optimizer aggregates every robot's graph), as the benches warm them."""
    from cslam_tpu_torch.selection import mac
    mac.warmup_selection_tiers(
        robots * steps, 2048, max_iters=det.lcm.candidate_selector.max_iters,
        device=device, **mac.mac_kwargs_from_params(det.params))
    for np_tier, ne_tier in backend.warmup_tier_grid(robots * steps,
                                                     2 * robots * steps):
        backend.warmup_tier(np_tier, ne_tier)


def rmse(poses: dict, truth: list) -> float:
    """Position RMSE of ``{i: pose}`` against ``truth[i] = (scene, pose)``."""
    errs = [np.linalg.norm(poses[i][:3, 3] - truth[i][1][:3, 3])
            for i in poses]
    return float(np.sqrt(np.mean(np.square(errs)))) if errs else -1.0


def run_nodes(nodes, bus, clock, steps, intake, gt, drifted, device,
              drain=60, dump_dir=None, log=print) -> dict:
    """Drive a warmed mission: per step every robot's ``intake(r, i)``,
    one simulated second, the timers and the bus; then ``drain`` more
    seconds for gossip and the last optimizations. Returns the report
    both benches print (keyframes, steady wall, kf/s, real-time factor,
    loops, ATE of robot 0, the span table) plus the port's counters:
    CUDA graph captures after the warmup, verification pairs and ICP-gate
    passes, K1, E1, E2, WHILE-node and segment-sum launches,
    ``mac.fw_dispatch`` and ``pgo.optimize`` seconds."""
    import torch

    from cslam_tpu_torch.ops import nns, segment_sum, small_linalg
    from cslam_tpu_torch.selection import mac
    from cslam_tpu_torch.utils import profiling
    cuda = torch.device(device).type == "cuda"
    synchronize(device)
    before = graph_counts()
    stages_before = mac.WOODBURY_FW_GRAPHS.by_program["lobpcg"]["replays"]
    profiling.reset_spans()
    nns.launches = 0
    small_linalg.reset_launches()
    segment_sum.reset_launches()
    t0 = time.perf_counter()
    with dump_pgo(dump_dir):
        for i in range(steps):
            if i % 25 == 0:
                log(f"# step {i}/{steps} at {time.perf_counter() - t0:.1f} s")
            for r in range(len(nodes)):
                intake(r, i)
            clock.advance(1.0)
            for ctx, *_ in nodes:
                ctx.poll_timers()
            bus.deliver()
        for _ in range(drain):
            clock.advance(1.0)
            for ctx, *_ in nodes:
                ctx.poll_timers()
            bus.deliver()
        synchronize(device)
    wall = time.perf_counter() - t0
    mac.wait_for_prefetches()
    launches = nns.launches
    small = (small_linalg.device_launch_counts(device) if cuda
             else {"eigh": 0, "svd": 0})
    sums = segment_sum.device_launch_count(device) if cuda else 0
    graphs = graph_delta(before)
    be0 = nodes[0][3]
    keyframes = sum(n[1].nb_local_keyframes for n in nodes)
    loops = sum(len(v) for v in be0.inter_robot_loop_closures.values())
    est = {k[1]: p for k, p in be0.current_pose_estimates.items()
           if k[0] == 0}
    spans = profiling.spans()
    counters = profiling.counters()
    sim_s = float(steps + drain)
    pairs = int(counters.get("verify.pairs", 0))
    passes = int(counters.get("verify.icp_gate_pass", 0))
    log("# where the steady-state time went (host-side spans):")
    for line in profiling.report().splitlines():
        log("#   " + line)
    return {
        "total_keyframes": keyframes,
        "steady_wall_clock_s": wall,
        "keyframes_per_s": keyframes / wall,
        "sim_seconds": sim_s,
        "real_time_factor": sim_s / wall,
        "inter_robot_loops": loops,
        "optimizations": be0.optimization_count,
        "ate_odometry_m": rmse({i: drifted[0][i] for i in range(steps)},
                               gt[0]),
        "ate_optimized_m": rmse(est, gt[0]) if est else float("nan"),
        "captures_after_warmup": graphs["captures"],
        "graphs": graphs,
        "verify_pairs": pairs,
        "icp_gate_pass": passes,
        "icp_gate_pass_rate": passes / pairs if pairs else None,
        "k1_launches": launches,
        "small_linalg_launches": small,
        "segment_sum_launches": sums,
        "while_launches": (mac.WOODBURY_FW_GRAPHS.by_program["lobpcg"]
                           ["replays"] - stages_before),
        "mac_fw_dispatch_s": spans.get("mac.fw_dispatch", {}).get(
            "total_s", 0.0),
        "pgo_optimize_s": spans.get("pgo.optimize", {}).get("total_s", 0.0),
        "spans": spans,
    }


def loop_keys(backend) -> list:
    """The verified inter-robot loops as sorted ``r,kf,r,kf`` keys (the
    benches' ``--dump-loops``)."""
    return sorted(
        f"{e.key_from.robot_id},{e.key_from.keyframe_id},"
        f"{e.key_to.robot_id},{e.key_to.keyframe_id}"
        for edges in backend.inter_robot_loop_closures.values()
        for e in edges)
