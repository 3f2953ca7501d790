#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs its main path on the GPU.

    python3 chip_smoke.py            # both phases, one CUDA device

Builds the hand-written kernels from the sources in the checkout, then runs:

* phase ``bank_scan`` — the bank search at the size its users run it
  (131072 x 64 bank, 100,000 seeded unit rows, batch 512, k = 10) through
  ``DescriptorBank`` on CUDA, for an f32 and a bf16 bank; then the kernel
  against its plain PyTorch version on the card (main shape, a tie case, an
  n < k case and a B = 700 case: exact indices, values within 1e-6), and
  times of the kernel, the plain version and ``torch.matmul`` +
  ``torch.topk`` (the library yardstick, which the port never calls);
* phase ``swarm`` — the port's ``SwarmSimulator`` on CUDA with 4 robots x
  120 keyframes (480 poses, the largest swarm on the dense MAC and PGO
  tiers), plus a two-robot run on CUDA held against the same run on the CPU
  (the plain versions).

Every kernel's launch counter is set to 0 just before each main-path run and
read just after; a kernel that did not launch fails the run. Prints the
card's ``name, power.limit``, then one ``{"kernels": [...]}`` line, then, as
the last line, ``{"ok": true, "device": {...}}``. Any failure exits non-zero
without the last line. Imports only the port, never JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

# H100 SXM published peaks (dense): memory bytes/s and FLOP/s by input type
_PEAK_BYTES = 3.35e12
_PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
_VALUE_TOL = 1e-6   # kernel and plain version round identically (see nns.py)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "?"


def _time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _compare(name, got, ref, failures) -> float:
    """Exact indices; finite values within _VALUE_TOL; -inf where -inf."""
    import torch
    (gv, gi), (rv, ri) = got, ref
    torch.cuda.synchronize()
    if not torch.equal(gi.long(), ri.long()):
        bad = (gi.long() != ri.long()).nonzero()[:5].tolist()
        failures.append(f"{name}: indices differ at {bad}")
    fin = torch.isfinite(rv)
    if not torch.equal(fin, torch.isfinite(gv)):
        failures.append(f"{name}: -inf slots differ")
        return float("inf")
    err = float((gv[fin] - rv[fin]).abs().max()) if bool(fin.any()) else 0.0
    if err > _VALUE_TOL:
        failures.append(f"{name}: max |value diff| {err} > {_VALUE_TOL}")
    print(f"  {name}: indices equal={torch.equal(gi.long(), ri.long())} "
          f"max_abs_err={err}")
    return err


def phase_bank_scan(results, failures):
    import numpy as np
    import torch

    from cslam_tpu_torch.matching.nns_bank import DescriptorBank
    from cslam_tpu_torch.ops import nns

    N, n, D, B, k = 131072, 100000, 64, 512, 10
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((n, D)).astype(np.float32)
    queries = rng.standard_normal((B, D)).astype(np.float32)
    out = {}
    for dtype in ("float32", "bfloat16"):
        bank = DescriptorBank(dim=D, capacity=N, dtype=dtype, device="cuda")
        bank.add_items(rows, list(range(n)))
        bank._sync_device()
        torch.cuda.synchronize()
        nns.launches = 0
        sims, idx = bank.search_batch_begin(queries, k)   # the main path
        torch.cuda.synchronize()
        launches = nns.launches
        print(f"  main path ({dtype} bank {N}x{D}, n={n}, B={B}, k={k}): "
              f"{launches} kernel launch(es)")
        if launches < 1:
            failures.append(f"bank_scan {dtype}: kernel not launched")
        if not (sims.shape == (B, k) and bool(torch.isfinite(sims).all())):
            failures.append(f"bank_scan {dtype}: bad result {sims.shape}")
        qt = torch.from_numpy(queries).cuda()
        err = _compare(f"{dtype} main shape", (sims, idx),
                       nns.cosine_topk_scan_ref(bank._bank, n, qt, k),
                       failures)
        itemsize = 2 if dtype == "bfloat16" else 4
        flops = 2.0 * B * n * D
        nbytes = n * D * itemsize + B * D * 4 + B * k * 8
        t_flops, t_bytes = flops / _PEAK_FLOPS[dtype], nbytes / _PEAK_BYTES
        rows_f = bank._bank[:n].float()
        q_k = nns._kernel_queries(bank._bank, qt)
        out[dtype] = {
            "launches_main_path": launches, "max_abs_err": err,
            "ms": _time_ms(lambda: nns.cosine_topk_scan(bank._bank, n, qt, k),
                           20),
            "plain_ms": _time_ms(
                lambda: nns.cosine_topk_scan_ref(bank._bank, n, qt, k), 3, 1),
            "library_ms": _time_ms(
                lambda: torch.topk(q_k @ rows_f.T, k, dim=1), 20),
            "bound_ms": max(t_flops, t_bytes) * 1e3,
            "bound_by": "operations" if t_flops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}
        print(f"  {dtype}: " + json.dumps(out[dtype]))
        if dtype == "float32":
            # tie case: duplicated rows across splits, query = the row
            tie = bank._bank.clone()
            for r in (300, 50000, 99999):
                tie[r] = tie[100]
            qt2 = qt[:8].clone()
            qt2[3] = tie[100]
            _compare("tie case", nns.cosine_topk_scan(tie, n, qt2, k),
                     nns.cosine_topk_scan_ref(tie, n, qt2, k), failures)
            got = nns.cosine_topk_scan(tie, n, qt2, k)
            if got[1][3, :4].tolist() != [100, 300, 50000, 99999]:
                failures.append(f"tie order {got[1][3, :4].tolist()}")
            _compare("n < k case (n=5, k=10)",
                     nns.cosine_topk_scan(bank._bank, 5, qt, k),
                     nns.cosine_topk_scan_ref(bank._bank, 5, qt, k), failures)
            q700 = torch.from_numpy(
                rng.standard_normal((700, D)).astype(np.float32)).cuda()
            _compare("B = 700 case", nns.cosine_topk_scan(bank._bank, n,
                                                          q700, k),
                     nns.cosine_topk_scan_ref(bank._bank, n, q700, k),
                     failures)
            _compare("k = 128 case", nns.cosine_topk_scan(bank._bank, n,
                                                          qt[:64], 128),
                     nns.cosine_topk_scan_ref(bank._bank, n, qt[:64], 128),
                     failures)
        del bank
        torch.cuda.empty_cache()
    results["bank_scan"] = out


def _two_robot_sim(device, nb_keyframes=30):
    from cslam_tpu_torch.runtime.simulator import (SwarmSimulator,
                                                   SyntheticWorld,
                                                   circle_trajectory)
    world = SyntheticWorld(nb_places=40, descriptor_dim=32, seed=0)
    trajs = [circle_trajectory(nb_keyframes, radius=10.0, nb_places=40),
             circle_trajectory(nb_keyframes, radius=10.0, nb_places=40,
                               start_angle=0.1, z=0.5)]
    sim = SwarmSimulator(2, world, trajs, config_overrides={
        "frontend.inter_robot_detection_period_sec": 3.0,
        "frontend.inter_robot_loop_closure_budget": 5,
        "backend.pose_graph_optimization_start_period_ms": 2000,
        "frontend.async_detection": False}, keyframe_period=0.5,
        device=device)
    sim.run(40.0, dt=0.25)
    return sim


def _fixed(sim, rid=0):
    return sorted(e.key() for e in
                  sim.robots[rid].detection.lcm.candidate_selector.fixed_edges)


def phase_swarm(results, failures, robots=4, keyframes=120):
    import torch

    from cslam_tpu_torch.ops import nns
    from cslam_tpu_torch.runtime.simulator import (SwarmSimulator,
                                                   SyntheticWorld,
                                                   circle_trajectory)
    from cslam_tpu_torch.utils import profiling
    world = SyntheticWorld(nb_places=40, descriptor_dim=32, seed=0)
    trajs = [circle_trajectory(keyframes, radius=10.0 + 0.3 * r,
                               nb_places=40, start_angle=0.05 * r, z=0.2 * r)
             for r in range(robots)]
    sim = SwarmSimulator(robots, world, trajs, config_overrides={
        "frontend.inter_robot_detection_period_sec": 3.0,
        "frontend.inter_robot_loop_closure_budget": 5,
        "backend.pose_graph_optimization_start_period_ms": 2000},
        keyframe_period=0.5, device="cuda")
    torch.cuda.synchronize()
    profiling.reset_spans()
    nns.launches = 0
    t0 = time.perf_counter()
    sim.run(keyframes * 0.5 + 10.0, dt=0.25)   # the main path
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = nns.launches
    print(profiling.report())
    per_robot = []
    for rid, robot in enumerate(sim.robots):
        odo, opt = sim.ate(rid)
        per_robot.append({
            "robot": rid, "keyframes": robot.detection.lcm.local_nnsm.n,
            "fixed_edges": len(
                robot.detection.lcm.candidate_selector.fixed_edges),
            "inter_lc": sum(len(v) for v in
                            robot.backend.inter_robot_loop_closures.values()),
            "optimizations": robot.backend.optimization_count,
            "ate_odom": odo, "ate_opt": opt})
    r0 = per_robot[0]
    print(f"  swarm {robots}x{keyframes}: {wall:.1f} s wall, "
          f"{launches} bank-scan launches")
    for rec in per_robot:
        print("  " + json.dumps(rec))
    if launches < 1:
        failures.append("swarm: bank-scan kernel not launched")
    if r0["fixed_edges"] < 1:
        failures.append("swarm: no fixed inter-robot edges")
    if not r0["ate_opt"] <= r0["ate_odom"] + 0.05:
        failures.append(f"swarm: optimized ATE {r0['ate_opt']} > odometry "
                        f"ATE {r0['ate_odom']} + 0.05")

    # small input held against the plain versions on the CPU
    cuda_sim, cpu_sim = _two_robot_sim("cuda"), _two_robot_sim("cpu")
    same = _fixed(cuda_sim) == _fixed(cpu_sim)
    ate_cuda, ate_cpu = cuda_sim.ate(0)[1], cpu_sim.ate(0)[1]
    print(f"  two-robot check: fixed edges equal={same} "
          f"({len(_fixed(cuda_sim))}), ATE cuda={ate_cuda} cpu={ate_cpu}")
    if not same:
        failures.append("two-robot sim: CUDA and CPU fixed edges differ")
    if not abs(ate_cuda - ate_cpu) <= 1e-3:
        failures.append(f"two-robot sim: ATE {ate_cuda} vs {ate_cpu}")
    results["swarm"] = {"launches": launches, "wall_s": wall,
                        "robots": per_robot}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default="bank_scan,swarm",
                        help="comma-separated subset of bank_scan,swarm")
    args = parser.parse_args()
    phases = args.phases.split(",")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from cslam_tpu_torch.ops import nns
    except ImportError as exc:
        print(f"chip_smoke: run from the repository root ({exc})",
              file=sys.stderr)
        return 2
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    lib = nns.build()
    print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s")
    for ptxas in sorted(nns.BUILD_DIR.glob("*.ptxas.txt")):
        print(ptxas.read_text().strip())

    results, failures = {}, []
    for phase in phases:
        print(f"phase {phase}")
        try:
            {"bank_scan": phase_bank_scan, "swarm": phase_swarm}[phase](
                results, failures)
        except Exception as exc:  # noqa: BLE001 - report, then fail the run
            import traceback
            traceback.print_exc()
            failures.append(f"{phase}: {type(exc).__name__}: {exc}")

    card = _card_line()
    print(card)
    f32 = results.get("bank_scan", {}).get("float32", {})
    kernel = {
        "name": "bank_scan", "route": "cuda",
        "source": "cslam_tpu_torch/csrc/bank_scan.cu",
        "replaces": "cslam_tpu/ops/nns_pallas.py:177",
        "launches": results.get("swarm", {}).get(
            "launches", f32.get("launches_main_path", 0)),
        "max_abs_err": f32.get("max_abs_err"),
        "ms": f32.get("ms"), "plain_ms": f32.get("plain_ms"),
        "bound_ms": f32.get("bound_ms"), "bound_by": f32.get("bound_by"),
        "library_ms": f32.get("library_ms"),
        "variants": {"bfloat16": results.get("bank_scan", {}).get(
            "bfloat16")}}
    print(json.dumps({"kernels": [kernel]}))
    if failures:
        for f in failures:
            print(f"FAIL {f}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
