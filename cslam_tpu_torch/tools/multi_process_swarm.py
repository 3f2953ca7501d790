#!/usr/bin/env python3
"""Multi-process swarm over the TCP transport, on the port.

The port's twin of ``examples/multi_process_swarm.py``. Each robot runs as
its OWN OS process (simulated sensor front end + detection front end + PGO
back end, all on the one CUDA device) and communicates only through the
``TransportHub`` that this process runs: the deployment shape of the
reference's DDS swarm, with unchanged node code.

    python3 cslam_tpu_torch/tools/multi_process_swarm.py [--robots 2]

Before it starts any robot, the parent builds the bank-scan kernels, so
that the robots load them instead of each running ``nvcc``. Each robot
prints its line, with its K1 launch count, and then one ``robot_result``
JSON line that :func:`run_swarm` reads. A robot that fails, or ends
without its result, fails the run. Runs on the CUDA device and raises
without one; ``--cpu`` asks for the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if __name__ == "__main__":
    sys.path.insert(0, _REPO)

_RESULT = "robot_result "


def robot_main(rid: int, nb_robots: int, port: int, duration: float,
               device: Optional[str] = None) -> dict:
    """One robot process: its nodes on a :class:`NetworkBus` to the hub at
    ``127.0.0.1:port``, driven on the wall clock for ``duration`` s."""
    from cslam_tpu_torch import resolve_device
    from cslam_tpu_torch.config import CslamConfig
    from cslam_tpu_torch.ops import nns
    from cslam_tpu_torch.runtime.backend_node import DecentralizedPGO
    from cslam_tpu_torch.runtime.bus import RobotContext
    from cslam_tpu_torch.runtime.clock import WallClock
    from cslam_tpu_torch.runtime.lcd_node import DetectionFrontEnd
    from cslam_tpu_torch.runtime.simulator import (IdentityDescriptorModel,
                                                   SimulatedSensorFrontEnd,
                                                   SyntheticWorld,
                                                   circle_trajectory)
    from cslam_tpu_torch.runtime.transport import NetworkBus

    device = resolve_device(device)
    cfg = CslamConfig(robot_id=rid, max_nb_robots=nb_robots)
    cfg.frontend.similarity_threshold = 0.8
    cfg.frontend.detection_publication_period_sec = 0.3
    cfg.frontend.inter_robot_detection_period_sec = 1.5
    cfg.backend.pose_graph_optimization_start_period_ms = 3000
    cfg.neighbor_management.enable_neighbor_monitoring = True
    cfg.neighbor_management.init_delay_sec = 0.0
    cfg.neighbor_management.heartbeat_period_sec = 0.2

    bus = NetworkBus(("127.0.0.1", port))
    ctx = RobotContext(bus, WallClock(), rid, cfg.flatten())
    world = SyntheticWorld(nb_places=30, descriptor_dim=32, seed=7)
    trajectory = circle_trajectory(20, radius=10.0 + 0.2 * rid,
                                   nb_places=30, start_angle=0.05 * rid)
    SimulatedSensorFrontEnd(ctx, world, trajectory, keyframe_period=0.4)
    detection = DetectionFrontEnd(ctx, model=IdentityDescriptorModel(),
                                  device=device)
    backend = DecentralizedPGO(ctx, synchronous_optimization=False,
                               device=device)
    # pay the one-time device costs (context, solver handles) before
    # traffic starts
    backend.warmup(expected_poses=nb_robots * 20, expected_edges=64)
    # only the elected robot of a group solves; the others receive its
    # result on this topic
    optimized_results = []
    ctx.create_subscription("cslam/optimized_estimates",
                            optimized_results.append)

    nns.launches = 0
    start = time.time()
    while time.time() - start < duration:          # the main path
        ctx.poll_timers()
        bus.deliver()
        time.sleep(0.02)
    launches = nns.launches

    result = {
        "robot": rid, "device": str(device),
        "keyframes": detection.lcm.local_nnsm.n,
        "fixed_edges": len(detection.lcm.candidate_selector.fixed_edges),
        "inter_lc": sum(len(v) for v in
                        backend.inter_robot_loop_closures.values()),
        "optimizations": backend.optimization_count,
        "optimized_results_received": len(optimized_results),
        "estimates": len(backend.current_pose_estimates),
        "k1_launches": launches,
        "frames_published": bus._pub_seq,
        "messages_delivered": bus.messages_delivered,
        "connection": {k: v for k, v in bus.connection_stats().items()
                       if k != "hub_address"},
        "foreign_modules": sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "cslam_tpu")),
    }
    print(f"r{rid}: keyframes={result['keyframes']} "
          f"fixed_edges={result['fixed_edges']} "
          f"inter_lc={result['inter_lc']} "
          f"optimizations={result['optimizations']} "
          f"optimized_results={len(optimized_results)} "
          f"estimates={result['estimates']} "
          f"k1_launches={launches}", flush=True)
    print(_RESULT + json.dumps(result), flush=True)
    bus.close()
    return result


def run_swarm(robots: int = 2, duration: float = 25.0,
              device: Optional[str] = None) -> List[dict]:
    """Run the hub here and one robot process per robot; return each
    robot's result. Raises if a robot exits non-zero, is still running
    ``duration`` + 180 s after the start, or prints no result."""
    from cslam_tpu_torch import resolve_device
    from cslam_tpu_torch.runtime.transport import TransportHub

    dev = resolve_device(device)
    if dev.type == "cuda":
        from cslam_tpu_torch.ops import nns
        nns.build()      # once here, not once per robot process
    hub = TransportHub()
    print(f"hub listening on {hub.address}", flush=True)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (_REPO, os.environ.get("PYTHONPATH")) if p)}
    # each robot writes to a file of its own: a robot blocked on a full
    # pipe while this process waits on another would stall the swarm
    logs = [tempfile.TemporaryFile("w+") for _ in range(robots)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__),
         "--robot-id", str(r), "--robots", str(robots),
         "--port", str(hub.address[1]), "--duration", str(duration),
         "--device", str(dev)],
        env=env, stdout=logs[r], stderr=subprocess.STDOUT, text=True)
        for r in range(robots)]
    deadline = time.time() + duration + 180.0
    outputs, errors = [], []
    try:
        for r, p in enumerate(procs):
            try:
                p.wait(timeout=max(1.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                errors.append(f"robot {r} timed out")
            if p.returncode != 0 and p.returncode is not None:
                errors.append(f"robot {r} exited with {p.returncode}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        hub.close()
    for log in logs:
        log.seek(0)
        outputs.append(log.read())
        log.close()
    results = []
    for r, out in enumerate(outputs):
        sys.stdout.write(out)
        lines = [ln for ln in out.splitlines() if ln.startswith(_RESULT)]
        if not lines:
            errors.append(f"robot {r} printed no result")
            continue
        results.append(json.loads(lines[-1][len(_RESULT):]))
    if errors:
        raise RuntimeError("multi-process swarm failed: " + "; ".join(errors))
    return results


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--robots", type=int, default=2)
    parser.add_argument("--duration", type=float, default=25.0)
    parser.add_argument("--robot-id", type=int, default=None,
                        help="internal: run as one robot process")
    parser.add_argument("--port", type=int, default=0,
                        help="internal: the hub's port")
    parser.add_argument("--device", default=None,
                        help="internal: the robots' torch device")
    parser.add_argument("--cpu", action="store_true",
                        help="run the robots on the CPU instead of the CUDA "
                             "device")
    args = parser.parse_args()
    device = "cpu" if args.cpu else args.device
    if args.robot_id is not None:
        robot_main(args.robot_id, args.robots, args.port, args.duration,
                   device)
        return
    run_swarm(args.robots, args.duration, device)


if __name__ == "__main__":
    main()
