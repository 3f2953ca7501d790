#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs its main path on the GPU.

    python3 chip_smoke.py                    # every phase, one CUDA device
    python3 chip_smoke.py --phases frontend  # one phase

Builds the hand-written kernels from the sources in the checkout (one
``nvcc`` per source, all at once), then runs:

* phase ``bank_scan`` — the bank search at the size its users run it
  (131072 x 64 bank, 100,000 seeded unit rows, batch 512, k = 10) through
  ``DescriptorBank`` on CUDA, for an f32 and a bf16 bank; then K1 against
  its plain PyTorch version on the card, bit for bit, on both sides of the
  path threshold (B = 1, 8, 16, 32, 512, 700; ties across splits, n < k,
  k = 128, and near-tie, identical, zero rows), with the survivors of the
  screen per query and its observed error beside its bound; and times of
  the kernel, the plain version and ``torch.matmul`` + ``torch.topk`` (the
  library yardstick, which the port never calls), warm and L2-flushed;
* phase ``segment_sum`` — the fixed-order sums of the PGO solvers
  (``csrc/segment_sum.cu``) against their plain version, bit for bit and
  twice, at the main path's shapes (``pgo_8x1024_pcg``'s flattened sweep
  problems, ``pgo_8x256``, ``pgo_8x512``'s distributed dense tier, the
  coarse alignment at 8 x 16 segments); beside each, whether the atomic
  sum it replaced (``index_add_`` / ``index_put_(accumulate=True)``)
  repeats bit for bit on the same inputs, and the times of the kernel,
  the plain version and that library call beside the bound; MAC's
  dense-tier Laplacian, which stays an accumulating ``index_put_``, held
  to repeat bit for bit at P = 512; the swarms, the distributed solves
  and ``large_tiers`` count the kernel's launches on the device (the step
  programs replay it from CUDA graphs);
* phase ``swarm`` — the port's ``SwarmSimulator`` on CUDA with 4 robots x
  120 keyframes (480 poses, the largest swarm on the dense MAC and PGO
  tiers; the back end's warmup captures the PGO step programs of every
  tier up to 480 poses, ``warmup_selection_tiers`` MAC's Frank-Wolfe
  programs of every tier up to 960 poses and 4,096 candidates, and a
  capture during the mission fails the run), with ``pgo.optimize``
  seconds, LM iterations, host reads and the step programs' replays,
  MAC's spans and the loop
  state's counters (FW iterations, evaluations, LOBPCG calls, live and
  masked iterations, host reads per selection within their bound), plus
  a two-robot run on CUDA held against the same run on the CPU (the
  plain versions);
* phase ``swarm_floored`` — the same mission with the tiers pinned as
  deployments pin them (``frontend.mac_p_floor``, ``backend.pgo_np_floor``
  and ``backend.pgo_ne_floor`` at 1024), so every selection runs MAC's
  Woodbury/LOBPCG tier and every optimization PGO's coarse-corrected PCG
  tier, with LOBPCG, LM and CG iterations, host reads (at most one per
  CG block of ``solver._CG_BLOCK`` iterations plus two per LM iteration
  in each PCG solve; one per FW iteration plus one per selection) and
  captures (none after the warmup) counted; the small-eigensolver kernels
  must run and no ``torch.linalg.eigh`` may see a CUDA tensor; the
  mission runs with ``CSLAM_TPU_DUMP_PGO`` set, and part ``pgo_dumps``
  loads every dumped graph (``np.load(allow_pickle=False)``, the JAX
  package's keys and dtypes) and replays the largest through
  ``tools/pgo_replay`` graphed and eagerly (the same rejected edges,
  positions equal (``_GNC_GRADUATION_LIMIT_M``), no capture);
* phase ``large_tiers`` — MAC at ``benchmarks/selection_bench.py``'s three
  tiers (5 x 100 poses / 100 candidates, 10 x 200 / 400, 10 x 500 / 1000:
  P = 512, 2048, 8192) through the port's ACM, lambda_2 of each selection
  held against scipy, the P = 2048 selection against the same on the CPU,
  each selection again graphed and eager (the same step programs launched
  one by one: the same edges and FW iterations) and, on the Woodbury
  tier, with each LOBPCG stage's captured body replayed until the host
  reads its stop flag clear (bit for bit the graphed selection, with the
  same LOBPCG stages and iterations); the small-eigensolver
  kernels (``csrc/small_eigh.cu``): the eigh against ``torch.linalg.eigh``
  on the Rayleigh-Ritz and SVQB matrices of a real P = 8192 evaluation
  and on random symmetric matrices with clustered and repeated
  eigenvalues, the SVD against ``torch.linalg.svd`` (in float64; beside
  it the float32 call, held on the main path's blocks) on the
  basis-extension blocks of one whole eager P = 8192 selection (up to
  64), seeded blocks at n = 1 .. 16 and rank-deficient ones, each kernel
  also bit for bit against its float64 mirror
  (``small_linalg.eigh_jacobi_ref``, ``svd_jacobi_ref``), with their
  times and device times beside the library calls';
  GNC-TLS cold (first with the tier's captures, then again) and warm on
  ``benchmarks/graphs``' 8 x 256 and 8 x 512 graphs (both outliers
  rejected, ATE within 0.05 m of the reference's ``*_optimized.g2o``),
  the LM steps replayed from CUDA graphs, and on 8 x 256 the cold solve
  twice eagerly (the same step programs launched one by one) held against
  the graphed one, the two eager runs bit for bit in positions and in
  every LM count (their sums run in a fixed order); the PCG tier's LM solve at 4096 nodes with CG blocks
  of 16, 8, 32 and 16 iterations; LM on a 2 x 288 graph on CUDA against
  the CPU; last, ``torch.profiler`` device times of one MAC evaluation and
  one graphed selection at P = 8192, one LM step, one PCG-tier LM solve
  and one CG block at 4096 nodes;
* phase ``distributed`` — the multi-device mode with every robot's block
  on the one card: ``mesh_banks``, ``MeshDescriptorBanks.search_all`` over
  8 robot shards at ``benchmarks/mesh_bank_bench.py``'s width (131,072 x
  64, 819,200 live rows, B = 256, k = 8; one K1 launch per shard, each bit
  for bit with its plain version), timed beside one shard's K1 and
  ``matmul`` + ``topk`` over the stacked banks; ``pgo_8x512``,
  ``distributed_optimize`` cold (its key's first solve, then again) and
  warm (carried weights) on ``benchmarks/graphs/pgo_8x512`` split by robot
  as the back end splits it, each graphed (the main path: the whole solve
  one launch of nested WHILE nodes) and on the plain route (host-driven
  sweeps), with seconds, sweeps, LM iterations, host reads (graphed: the
  results' 5 only), plan launches, captures and replays per program (none
  after the key's first solve), the failed Cholesky factorizations of the
  coarse alignment and of the local coarse factors (fault F5), the
  outliers' and genuine separators' weights, graphed against plain (the
  same sweeps and separator sides, positions within
  ``_DIST_POSE_LIMIT_M``), and the device ms per replay of each program
  of the sweep and of the plain route's batched LM step;
  ``pgo_8x1024_pcg``, ``benchmarks/distributed_pgo_bench.py``'s world at 8
  x 1,024 poses (its twin, ``tools/distributed_pgo_bench``), every robot
  on the PCG tier: graphed (the batched PCG programs) against each robot's
  ``lm_optimize`` in turn, with the same checks and the centralized GNC
  beside; ``swarm_distributed``, a 4 x 60 swarm with
  ``backend.pgo_mode: distributed`` (every robot within odometry ATE +
  0.05 m, at least two improve, no capture in a solve whose key was
  captured before); ``process_group``,
  ``tools/dryrun_multichip`` with 4 gloo rank processes on the card held
  against the stacked run of the same problem (poses within 1e-4, the same
  sweeps, K1 launched in every rank, no ``jax`` / ``cslam_tpu`` module),
  with the bytes gathered per sweep;
* phase ``frontend`` — the visual front end's flagship step: CosPlace
  ResNet18 + GeM (fc 64, the seeded golden weights) from
  ``make_global_descriptor`` embeds seeded 480 x 640 keyframes (crop 376 ->
  224) through ``compute_embedding_begin``/``finish`` (B = 1) and
  ``compute_embeddings`` (B = 32), held against the same model on the CPU
  with TF32 off; then ``entry.frontend_step`` (the twin of
  ``__graft_entry__.entry``) at B = 1 and B = 32 against a 131072 x 64 bank
  of 100,000 non-unit rows, k = 8, its search the tile-scan kernel K2, held
  against ``ops.topk.cosine_topk``; then K2 against its plain version, bit
  for bit, on the cases K1 takes (plus norms from 1e-3 to 1e3), f32 and
  bf16 banks; K2's times at B = 1 and B = 512 beside its plain version,
  ``torch.topk`` of ``matmul`` (the library yardstick) and its bound; last,
  ``torch.profiler`` device times and CUDA kernels per call of the step, of
  K2 and of K1 (the profiler may slow what runs after it, so it runs after
  every timing);
* phase ``lidar`` — the lidar path at the lidar mission's width
  (``benchmarks/lidar_e2e_scale_bench.py``): ``sc_search``, a seeded
  65,536-scan bank (``benchmarks/scancontext_scale_bench.py``'s scans)
  searched in 16-query chunks and at B = 1 through ``ScanContextBank``,
  unfused (stage 1 ``euclidean_topk``) and fused (stage 1 = K1 on the
  augmented ring keys), the best rows equal and K1 bit for bit with its
  plain version there, with survivors per query; ``verify``, one 8-pair
  verification chunk at pad_size 1024, replayed from its tier's CUDA
  graph (4 revisits with a known yaw and offset within 0.1 m and 1 degree,
  4 cross-scene pairs rejected, the flags equal to the CPU's and the
  outputs to the eager chunk's), its time graphed and eager, CUDA kernels,
  graph launches, idle share and the graph pool's bytes; ``mission``, 3
  robots x 40 steps of the bench's mission through
  ``tools/lidar_e2e_scale.run_mission`` (the lidar, detection and
  back-end nodes; at least one verified inter-robot loop, robot 0's
  optimized ATE <= odometry ATE + 0.05 m, every chunk a replay of a graph
  the warmup captured, the verification, MAC and PGO programs warmed as
  the bench warms them and none captured on the main thread after that),
  with its spans (a prefetch thread's as ``(bg)``) and its captures and
  replays per program set;
* phase ``visual`` — the visual (RGB-D / stereo) path at
  ``benchmarks/visual_e2e_scale_bench.py``'s widths: ``visual_verify``, one
  16-pair chunk at ``benchmarks/verification_bench.py``'s widths (512
  correspondence slots, 200 live, 20% outliers) through ``gnc_align_batch``
  and, for the same poses projected through the bench's 320 x 240 camera,
  through ``gnc_pnp_batch``, each replayed from its tier's CUDA graph
  (every pair within 1 degree and 0.05 m of the truth, inlier counts equal
  to the CPU's and to the eager chunk's, no host sync inside a chunk),
  with times graphed and eager, CUDA kernels, graph launches, idle share,
  peak memory and pool bytes; ``visual_mission``,
  3 robots x 40 steps of the bench's rendered mission through
  ``tools/visual_e2e_scale.run_mission`` (``RGBDFrontEnd`` ->
  ``DetectionFrontEnd`` (CosPlace, the visual bank on K1) ->
  ``DecentralizedPGO``; the C++ feature library loaded, at least one
  verified inter-robot loop, robot 0's optimized ATE <= odometry ATE +
  0.05 m, no capture after the warmup as in the lidar mission);
  ``visual_stereo``, two ``StereoFrontEnd``s from
  ``make_map_manager`` exchanging a keyframe (the CPU's flags, within 0.12
  m of the truth), then the mission's stereo variant at 3 x 20 through the
  same node stack (the same limits);
* phase ``deploy`` — the deployment entry points: ``stereo_replay``, the
  port's ``ReplayDriver`` over two KITTI-layout stereo sequences (2 x 20
  frames at 1241 x 376 with sequence 00's published camera, written by
  ``write_kitti_sequence`` through the port's own PNG codec) with
  ``TinyImageDescriptor``, every robot's detection and back end snapshot
  halfway and restored into fresh CUDA nodes, the replay then going on
  there, and the same snapshot loaded into CPU nodes (limits: a verified
  inter-robot loop, robot 0's ATE <= odometry ATE + 0.05 m, K1 launched
  before and after the restore, keyframes and fixed edges growing after it,
  the CPU nodes' banks and best rows equal); ``lidar_replay``, the
  ``LidarReplayDriver`` over two ``velodyne/*.bin`` sequences of 2 x 20
  sweeps of 120,000 points (one HDL-64E sweep) with the scan-context banks
  on the fused stage 1 and the experiment logger on robot 0 (the same
  limits, K1 launched through the scan-context bank, ``metrics.csv`` and
  both g2o dumps written with a finite ``graph_error``), then a printed
  probe of the verification on ground-dominated 120,000-point clouds;
  ``swarm_processes``, ``tools/multi_process_swarm.run_swarm`` with 3 robot
  processes on the card for 20 s over the TCP hub (every robot exits 0
  with fixed edges, an optimized result and K1 launches, and has imported
  neither ``jax`` nor ``cslam_tpu``; the transport refuses a frame that
  holds a tensor);
* phase ``gnc_sweep`` — ``tools/gnc_scenario_sweep`` at its quick tiers
  (3 x 80 and 5 x 100 poses, 10 seeded scenarios with gross outliers),
  each scenario graphed and eager after a back end's warmup of their GNC
  tiers (the same rejected edges in every scenario, 0 missed outliers,
  0 ATE regressions, false rejections no more than the JAX package's
  CPU sweep, no capture);
* phase ``scale`` — ``tools/lidar_e2e_scale.run_mission`` at the bench's
  own size and pins: 5 robots x 210 keyframes, MAC and PGO tiers pinned
  at 2,048, the port's warmup of exactly the reachable tiers (no capture
  after it, at least one verified loop, robot 0's ATE bar, K1 and the
  Woodbury tier's kernels launched);
* phase ``mac_calls`` — MAC's calls one by one (``torch.profiler``: wall
  and device ms, CUDA kernels, copies to the host and host syncs per
  call): ``torch.linalg.eigh`` of the dense tier's deflated Laplacian and
  one FW evaluation at P = 64 .. 512, one Woodbury evaluation at P =
  1024, 2048, 8192, each with its selection's time; then one LOBPCG stage
  as a CUDA graph while loop (``csrc/graph_while.cu``, the main path),
  as its body replayed from the host and eagerly (the plain version) at
  (P, E) = (1024, 1024), (1024, 4096), (8192, 1024): the while loop and
  its body replayed until the host reads the stop flag clear stop at the
  same iteration with Ritz values within 4 float32 eps of max |theta|
  (the same kernels; eager's are printed); the same stage as it ran with
  two triangular solves per apply (before), the apply against
  ``fiedler.woodbury_inverse_ref`` within 32 float32 eps of max |Tinv x|,
  no ``trsm`` in the body, state and pool bytes; where the host's
  time goes in a graphed selection at P = 512, 1024, 8192, and the device
  ms and kernels of one replay of each selection program. Its first part
  runs in an older checkout too (copy this file there and pass
  ``--phases mac_calls``).

Not in the default run: phase ``mac_replay`` records every MAC selection of
the ``swarm_floored`` mission (its inputs, in memory), then replays them,
graphed, in fresh processes through the ``cslam_tpu_torch`` of each tree
given by ``--replay-roots`` (default: this checkout) in the order a, b,
b, a, each time twice graphed and once eagerly, and reports per tree the
FW iterations, LOBPCG calls and ``mac.fw_dispatch`` seconds on the same
inputs, and per selection whether two replays (the trees, or one tree
graphed and eager) pick the same edges and the exact lambda_2 (float64,
dense) of each selected graph; a tree whose graphed runs disagree fails
it. To hold
this checkout against another on the same card:

    python3 chip_smoke.py --phases mac_replay --replay-roots OTHER,.

Not in the default run either: phase ``small_svd_ab`` runs the SVD kernel
of each tree of ``--replay-roots`` in fresh processes, a, b, b, a, on the
same inputs (the basis-extension blocks of one eager Woodbury selection
at P = 1024, seeded and rank-deficient blocks): CUDA-event, device and
graph-replayed ms at 4 x 4 and 12 x 12, batch 1, and at batch 1,024, with
the SM clock, the sweeps per block, and which outputs differ between the
trees (``--phases small_svd_ab --replay-roots OTHER,.``).

Every kernel's launch counter is set to 0 just before each main-path run and
read just after; a kernel that did not launch fails the run. The missions
and replays also count the verification graphs' captures and replays
around their main path: a capture after the warmup fails the run. Prints the
card's ``name, power.limit``, then one ``{"kernels": [...]}`` line, then, as
the last line, ``{"ok": true, "device": {...}}``. Any failure exits non-zero
without the last line. Imports only the port, never JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import struct
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM published peaks (dense): memory bytes/s; FLOP/s of the tensor
# cores by the screen's input type (an f32 bank is screened in TF32, a bf16
# bank in bf16) and of the FP32 cores outside them
_PEAK_BYTES = 3.35e12
_PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
_PEAK_FP32 = 67e12
_VALUE_TOL = 1e-6   # frontend_step against ops.topk.cosine_topk (other order)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "?"


def _sync() -> None:
    """``torch.cuda.synchronize()`` after any CUDA graph capture in flight
    (``utils.tier_graphs.synchronize``): ACM's prefetch threads capture
    the next selection tier in the background, and a device-wide
    synchronize during a capture fails. An older checkout has no such
    captures."""
    import torch

    from cslam_tpu_torch.utils import tier_graphs
    getattr(tier_graphs, "synchronize", torch.cuda.synchronize)()


def _wait_prefetches() -> None:
    """Wait for ACM's background prefetches of selection tiers (an older
    checkout has none): the profiler synchronizes the whole device, which
    fails during a capture. Called outside any selection."""
    from cslam_tpu_torch.selection import mac
    getattr(mac, "wait_for_prefetches", lambda: None)()


def _time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    _sync()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    _sync()
    return start.elapsed_time(stop) / iters


def _time_cold_ms(fn, iters: int, flush, warmup: int = 2) -> float:
    """Mean CUDA-event time of ``fn`` with the L2 cache flushed (``flush``
    writes a buffer larger than it) before each call, as a caller that
    searches once per keyframe finds it."""
    import torch
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        pairs.append((start, stop))
    _sync()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def _graph_call_ms(fn, calls: int = 100, replays: int = 10) -> float:
    """Device ms per call of ``fn`` run back to back from one CUDA graph
    of ``calls`` calls (CUDA events over ``replays`` replays): a kernel's
    time as a captured loop runs it, with the host out of the way and the
    card kept busy."""
    import torch
    fn()
    _sync()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    _sync()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    _sync()
    return start.elapsed_time(stop) / (replays * calls)


def _sm_clock_mhz():
    """The card's SM clock now (``nvidia-smi``), or None."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, timeout=60)
    try:
        return int(out.stdout.split()[0])
    except (IndexError, ValueError):
        return None


def _bound(flops: float, nbytes: float, dtype: str) -> dict:
    """The least time the card could take for ``flops`` on the tensor cores
    (the screen's input type) and ``nbytes`` of memory traffic, and the same
    on the FP32 cores (the rate the exact rescore runs at)."""
    rate = _PEAK_FP32 if dtype == "fp32" else _PEAK_FLOPS[dtype]
    t_flops, t_bytes = flops / rate, nbytes / _PEAK_BYTES
    return {"bound_ms": max(t_flops, t_bytes) * 1e3,
            "bound_by": "operations" if t_flops >= t_bytes else "bytes",
            "bound_fp32_ms": max(flops / _PEAK_FP32, t_bytes) * 1e3,
            "flops": flops, "bytes": nbytes}


_HOST_SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
               "cudaEventSynchronize")


def _device_profile(fn, iters: int = 20) -> dict:
    """Per call: the host wall time, the device time of every CUDA kernel
    ``fn`` launches, of the bank scans' scan kernels (``screen_kernel``,
    ``small_kernel``), merge kernel and cuBLAS triangular solves
    (``trsm``) (``torch.profiler``), the number of
    CUDA kernels and of ``cudaGraphLaunch`` calls (the CUDA-API count),
    the copies to the host and host synchronizations (each a host read),
    the five kernels that take most device time (name, calls, ms), and
    the device's idle share of the wall; device times are
    ``None`` where the profiler saw none. Run it after every timing: its
    tracing may slow what runs after it."""
    import warnings

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    _sync()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            _sync()
            wall_ms = (time.perf_counter() - t0) * 1e3 / iters
        averages = prof.key_averages()
        kernels = [e for e in averages if e.device_type == DeviceType.CUDA]
        graph_launches = sum(e.count for e in averages
                             if e.key == "cudaGraphLaunch") / iters
        reads = {"dtoh_copies_per_call": sum(
            e.count for e in kernels if "DtoH" in e.key) / iters,
                 "host_syncs_per_call": sum(
            e.count for e in averages if e.key in _HOST_SYNCS) / iters}

    def ms(pick):
        return sum(e.device_time_total for e in kernels
                   if pick(e.key)) / 1e3 / iters
    device_ms = ms(lambda key: True)
    if device_ms <= 0:
        return {"wall_ms": wall_ms, "device_ms": None, "idle_share": None,
                "kernels_per_call": None,
                "graph_launches_per_call": graph_launches, **reads}
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "graph_launches_per_call": graph_launches, **reads,
            "top_kernels": sorted(
                ([e.key[:60], e.count / iters,
                  e.device_time_total / 1e3 / iters] for e in kernels),
                key=lambda r: -r[2])[:5],
            "scan_kernel_ms": ms(lambda key: "screen_kernel" in key
                                 or "small_kernel" in key),
            "merge_kernel_ms": ms(lambda key: "merge_kernel" in key),
            "trsm_kernel_ms": ms(lambda key: "trsm" in key),
            "kernels_per_call": sum(e.count for e in kernels) / iters,
            "idle_share": max(0.0, 1.0 - device_ms / wall_ms)}


def _compare(name, got, ref, failures, tol=0.0) -> float:
    """Exact indices; finite values within ``tol`` (a kernel against its
    plain version: 0, bit for bit); -inf where -inf."""
    import torch
    (gv, gi), (rv, ri) = got, ref
    _sync()
    if not torch.equal(gi.long(), ri.long()):
        bad = (gi.long() != ri.long()).nonzero()[:5].tolist()
        failures.append(f"{name}: indices differ at {bad}")
    fin = torch.isfinite(rv)
    if not torch.equal(fin, torch.isfinite(gv)):
        failures.append(f"{name}: -inf slots differ")
        return float("inf")
    err = float((gv[fin] - rv[fin]).abs().max()) if bool(fin.any()) else 0.0
    if err > tol:
        failures.append(f"{name}: max |value diff| {err} > {tol}")
    print(f"  {name}: indices equal={torch.equal(gi.long(), ri.long())} "
          f"max_abs_err={err}")
    return err


def _scan_case(kernel, name, bank, inv, n, q, k, failures):
    """One call of K1 (``bank_scan``) or K2 (``tile_scan``) against its
    plain version, bit for bit; then the same call with the kernel's
    counters on: survivors per query (filter passes) and, on the screen
    path, the largest observed |s~ - v| / (||q|| ||b|| |inv|) beside the
    kernel's eps / (||q|| ||b|| |inv|). Returns (record, result)."""
    import torch

    from cslam_tpu_torch.ops import nns
    if kernel == "bank_scan":
        def run(stats=None):
            return nns._cosine_topk_scan_cuda(bank, n, q, k, stats=stats)
        ref = nns.cosine_topk_scan_ref(bank, n, q, k)
    else:
        def run(stats=None):
            return nns._cosine_topk_fused_cuda(bank, inv, n, q, k,
                                               stats=stats)
        ref = nns.cosine_topk_fused_ref(bank, inv, n, q, k)
    dtype = str(bank.dtype).split(".")[-1]
    got = run()
    err = _compare(f"{kernel} {dtype} {name}", got, ref, failures)
    stats = torch.zeros(8, dtype=torch.int32, device="cuda")
    run(stats)
    survivors, bits = stats[:2].tolist()
    cycles = stats[2:].view(torch.int64).tolist()
    B = q.shape[0]
    screen = B >= nns.SCREEN_MIN_B
    rec = {"case": name, "dtype": dtype, "B": B, "k": k, "n": n,
           "path": "screen" if screen else "small", "max_abs_err": err,
           "survivors_per_query": survivors / B,
           # block time by phase: screen path (tile wait, screen + filter,
           # exact rescore + insertion); small path (tile wait, dots +
           # insertion, the block's final merge)
           "phase_shares": [c / max(1, sum(cycles)) for c in cycles]}
    if screen:
        eps = nns.SCREEN_EPS["tf32" if dtype == "float32" else
                             "bf16" if kernel == "bank_scan"
                             else "bf16_rounded_queries"]
        observed = struct.unpack("f", struct.pack("I", bits & 0xFFFFFFFF))[0]
        rec.update(max_screen_err_over_qb=observed, eps_over_qb=eps)
        if not observed <= eps:
            failures.append(f"{kernel} {dtype} {name}: screen error "
                            f"{observed} above its bound {eps}")
    print("    " + json.dumps(rec))
    return rec, got


def _scan_cases(kernel, bank, inv, n, rng, failures):
    """Every case of one kernel on one bank (f32 or bf16, 131072 x 64,
    ``n`` valid rows) on both sides of the path threshold, all exact: the
    batch sizes, ties across splits, n < k, k = 128 (K1), and adversarial
    banks of 20,000 rows: near-ties, identical rows (every row survives the
    screen), zero rows and (K2) norms from 1e-3 to 1e3."""
    import numpy as np
    import torch
    D, dtype = bank.shape[1], bank.dtype
    k = 10
    cases = []

    def queries(B):
        return torch.from_numpy(rng.standard_normal((B, D)).astype(
            np.float32)).cuda()

    def case(name, b, inv_, n_, q, k_=k):
        rec, got = _scan_case(kernel, name, b, inv_, n_, q, k_, failures)
        cases.append(rec)
        return got

    for B in (1, 8, 16, 32, 700):
        case("random rows", bank, inv, n, queries(B))
    tie = bank.clone()
    tie_inv = None if inv is None else inv.clone()
    for r in (300, 50000, 99999):
        tie[r] = tie[100]
        if inv is not None:
            tie_inv[r] = tie_inv[100]
    for B in (8, 32):
        q = queries(B)
        q[3] = tie[100].float()
        got = case("ties across splits", tie, tie_inv, n, q)
        if got[1][3, :4].tolist() != [100, 300, 50000, 99999]:
            failures.append(f"{kernel} tie order B={B}: "
                            f"{got[1][3, :4].tolist()}")
    for B in (1, 512):
        got = case("n < k (n=5)", bank, inv, 5, queries(B))
        if kernel == "tile_scan" and not (
                bool(got[1][:, 5:].eq(0).all())
                and bool(got[0][:, 5:].isneginf().all())):
            failures.append(f"tile_scan n < k B={B}: tail is not (-inf, 0)")
    if kernel == "bank_scan":
        for B in (8, 64):
            case("k = 128", bank, inv, n, queries(B), 128)

    n_adv = 20000
    base = rng.standard_normal(D)
    raw = rng.standard_normal((n_adv, D))
    adversarial = {
        "near ties": base + 1e-7 * rng.standard_normal((n_adv, D)),
        "identical rows": np.tile(base, (n_adv, 1)),
        "zero rows": np.where((np.arange(n_adv) % 3 == 0)[:, None], 0.0,
                              raw)}
    if kernel == "tile_scan":
        adversarial["norms 1e-3 to 1e3"] = raw * np.logspace(
            -3, 3, n_adv)[rng.permutation(n_adv)][:, None]
    for name, rows in adversarial.items():
        rows = torch.from_numpy(rows.astype(np.float32)).cuda()
        inv_a = None
        if kernel == "tile_scan":
            inv_a = 1.0 / torch.clamp(rows.norm(dim=1), min=1e-12)
        b = rows.to(dtype)
        for B in (8, 32):
            q = queries(B)
            q[0] = torch.from_numpy(base.astype(np.float32)).cuda()
            got = case(name, b, inv_a, n_adv, q)
            if name == "identical rows" and got[1][0].tolist() != list(
                    range(k)):
                failures.append(f"{kernel} identical rows B={B}: "
                                f"{got[1][0].tolist()}")
    return cases


def phase_bank_scan(results, failures):
    import numpy as np
    import torch

    from cslam_tpu_torch.matching.nns_bank import DescriptorBank
    from cslam_tpu_torch.ops import nns

    N, n, D, B, k = 131072, 100000, 64, 512, 10
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((n, D)).astype(np.float32)
    queries = rng.standard_normal((B, D)).astype(np.float32)
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    flush = scratch.zero_                    # 256 MB > the 50 MB L2
    out = {}
    for dtype in ("float32", "bfloat16"):
        bank = DescriptorBank(dim=D, capacity=N, dtype=dtype, device="cuda")
        bank.add_items(rows, list(range(n)))
        bank._sync_device()
        _sync()
        nns.launches = 0
        sims, idx = bank.search_batch_begin(queries, k)   # the main path
        _sync()
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
        main, _ = _scan_case("bank_scan", "main shape", bank._bank, None, n,
                             qt, k, failures)
        itemsize = 2 if dtype == "bfloat16" else 4
        rows_f = bank._bank[:n].float()
        q_k = nns._kernel_queries(bank._bank, qt)

        def kernel():
            return nns.cosine_topk_scan(bank._bank, n, qt, k)

        def library():
            return torch.topk(q_k @ rows_f.T, k, dim=1)
        out[dtype] = {
            "launches_main_path": launches, "max_abs_err": err,
            "survivors_per_query": main["survivors_per_query"],
            "phase_shares": main["phase_shares"],
            "max_screen_err_over_qb": main.get("max_screen_err_over_qb"),
            "eps_over_qb": main.get("eps_over_qb"),
            "ms": _time_ms(kernel, 20),
            "ms_l2_flushed": _time_cold_ms(kernel, 20, flush),
            "plain_ms": _time_ms(
                lambda: nns.cosine_topk_scan_ref(bank._bank, n, qt, k), 3, 1),
            "library_ms": _time_ms(library, 20),
            "library_ms_l2_flushed": _time_cold_ms(library, 20, flush),
            **_bound(2.0 * B * n * D, n * D * itemsize + B * D * 4
                     + B * k * 12, dtype)}
        print(f"  {dtype}: " + json.dumps(out[dtype]))
        out[dtype]["cases"] = _scan_cases("bank_scan", bank._bank, None, n,
                                          rng, failures)
        del bank
        torch.cuda.empty_cache()
    results["bank_scan"] = out


# -- segment_sum: the solvers' fixed-order sums (csrc/segment_sum.cu) ------

#: the atomic sums the kernel replaced, by plan form: a per-node plan's
#: ``index_add_`` over its keys, a compact plan's accumulating
#: ``index_put_`` into its rows
_SEGMENT_REPEATS = 2


def _segment_cases():
    """The kernel's shapes on the main path, as (name, sources, plan, rows,
    keys): the normal-equation sums of ``pgo_8x1024_pcg`` (the distributed
    bench's world, 8 robots x 1,024 poses on the PCG tier, the sweeps'
    flattened local problems: CG matvec and gradient rows of 6, Hessian
    blocks of 36, the coarse level's segment sums), of ``pgo_8x256`` (the
    centralized GNC's 2,048 nodes on the PCG tier), of ``pgo_8x512``'s
    distributed dense tier (the batched step's off-diagonal blocks), the
    coarse alignment at 8 robots x 16 segments. Sources are the solvers'
    own rows at the init poses (unit weights); ``keys`` are the
    destinations the replaced atomic sum took, padding included."""
    import numpy as np
    import torch

    from cslam_tpu_torch.pgo import distributed as td, solver
    from cslam_tpu_torch.tools import distributed_pgo_bench as bench
    from cslam_tpu_torch.utils.robot_mesh import StackedMesh

    def linear(g):
        r, Ji, Jj, rp, Jp = solver._linearize(g.poses, g)
        w = g.edge_valid
        aw = torch.einsum("eij,ej->ei", Ji, torch.ones_like(r)) * w[:, None]
        return {"matvec_6": torch.cat([
            torch.einsum("eij,ei->ej", Ji, aw),
            torch.einsum("eij,ei->ej", Jj, aw),
            torch.einsum("bij,bi->bj", Jp, rp)]),
            "hessian_36": torch.cat([
                (Ji.transpose(1, 2) @ Ji * w[:, None, None]).reshape(-1, 36),
                (Jj.transpose(1, 2) @ Jj * w[:, None, None]).reshape(-1, 36),
                (Jp.transpose(1, 2) @ Jp).reshape(-1, 36)]),
            "J": (Ji, Jj, Jp)}

    def node_keys(g):
        return torch.cat([g.edge_i, g.edge_j, g.prior_idx])

    cases = []
    for tag, g, R in _segment_graphs():
        plans = solver.segment_plans(g, R)
        lin = linear(g)
        N = g.poses.shape[0]
        cases.append((f"{tag}_matvec_6", lin["matvec_6"], plans["node"],
                      None, node_keys(g), N))
        cases.append((f"{tag}_hessian_36", lin["hessian_36"], plans["node"],
                      None, node_keys(g), N))
        if "seg" in plans:
            S = max(1, (N // R) // solver._COARSE_SEG)
            seg = solver._coarse_segments(N, R, g.poses.device)
            A = torch.randn(N, 6, 6, device=g.poses.device)
            Ji, Jj, Jp = lin["J"]
            src = torch.cat([
                (Ji @ A[g.edge_i]).transpose(1, 2) @ (Jj @ A[g.edge_j])
                for _ in range(4)] + [(Jp @ A[g.prior_idx]).transpose(
                    1, 2) @ (Jp @ A[g.prior_idx])]).reshape(-1, 36)
            si, sj, sp = seg[g.edge_i], seg[g.edge_j], seg[g.prior_idx]
            keys = torch.cat([si * S + si % S, si * S + sj % S,
                              sj * S + si % S, sj * S + sj % S,
                              sp * S + sp % S])
            cases.append((f"{tag}_coarse_apply_6",
                          torch.randn(N, 6, device=g.poses.device)
                          * g.node_valid[:, None], plans["seg"], None, seg,
                          R * S))
            cases.append((f"{tag}_galerkin_36", src, plans["seg_pair"],
                          R * S * S, keys, R * S * S))
        if "pair" in plans:
            Ji, Jj, _ = lin["J"]
            Np = N // R
            blk = (Ji.transpose(1, 2) @ Jj).reshape(-1, 36)
            keys = torch.cat([g.edge_i * Np + g.edge_j % Np,
                              g.edge_j * Np + g.edge_i % Np])
            cases.append((f"{tag}_offdiag_36", torch.cat([blk, blk]),
                          plans["pair"], N * Np, keys, N * Np))
    # the coarse alignment's blocks at the bench world's 8 x 16 segments
    _, problem, _, _ = bench.build(8, 1024, np.random.default_rng(0), 16)
    _, sep = problem.to_device_arrays(StackedMesh(8, "cuda"))
    M = sep["coarse_segments"]
    plans = td._coarse_plans(sep, 8, M, sep["coarse_seg_len"])
    *_, v0, v1, _, _ = td._coarse_edges(sep, sep["cross"], M,
                                        sep["coarse_seg_len"])
    V = 8 * M
    A = torch.randn(v0.shape[0], 36, device="cuda") * torch.cat(
        [sep["valid"], sep["cross"]["valid"]])[:, None]
    cases.append(("align_8x16_36", torch.cat([A, A, -A, -A]),
                  plans["pair"], V * V,
                  torch.cat([v1 * V + v1, v0 * V + v0, v0 * V + v1,
                             v1 * V + v0]), V * V))
    return cases


def _laplacian_repeats(failures):
    """MAC's dense-tier Laplacian (``fiedler.laplacian_from_edges``, four
    accumulating ``index_put_``s, which PyTorch sorts on the card) at
    P = 512 with 4,096 seeded candidates, many of them sharing a node:
    ``_SEGMENT_REPEATS`` runs on the same inputs must agree bit for bit,
    the evidence for leaving it an ``index_put_`` (a failure if not)."""
    import torch

    from cslam_tpu_torch.ops import fiedler as fd
    gen = torch.Generator(device="cuda").manual_seed(3)
    P, E = 512, 4096
    ci = torch.randint(0, P, (E,), device="cuda", generator=gen)
    cj = torch.randint(0, P, (E,), device="cuda", generator=gen)
    w = torch.rand(E, device="cuda", generator=gen)
    runs = [fd.laplacian_from_edges(ci, cj, w, P)
            for _ in range(_SEGMENT_REPEATS)]
    rec = {"P": P, "E": E,
           "repeats": all(torch.equal(runs[0], r) for r in runs[1:]),
           "ms": _graph_call_ms(
               lambda: fd.laplacian_from_edges(ci, cj, w, P), 100)}
    if not rec["repeats"]:
        failures.append("segment_sum: MAC's dense-tier Laplacian "
                        "(index_put_ accumulate) differs between two runs")
    print("  segment_sum laplacian_512 " + json.dumps(rec))
    return rec


def _segment_graphs():
    """(tag, graph, robots): ``pgo_8x1024_pcg``'s flattened sweep problems,
    ``pgo_8x256`` centralized and ``pgo_8x512``'s flattened sweep problems
    (dense tier), on the card."""
    import numpy as np

    from cslam_tpu_torch.pgo import distributed as td
    from cslam_tpu_torch.pgo.distributed import split_factor_graph
    from cslam_tpu_torch.tools import distributed_pgo_bench as bench
    from cslam_tpu_torch.utils.robot_mesh import StackedMesh
    out = []
    _, problem, _, _ = bench.build(8, 1024, np.random.default_rng(0), 16)
    local, sep = problem.to_device_arrays(StackedMesh(8, "cuda"))
    out.append(("pgo_8x1024_pcg", td._flatten(td._sweep_layout(local, sep)),
                8))
    out.append(("pgo_8x256", _g2o_graph(
        "benchmarks/graphs/pgo_8x256_init.g2o")[1], 1))
    graph, _ = _g2o_graph("benchmarks/graphs/pgo_8x512_init.g2o")
    problem, _ = split_factor_graph(graph, 0)
    local, sep = problem.to_device_arrays(StackedMesh(problem.nb_robots,
                                                      "cuda"))
    out.append(("pgo_8x512_dist", td._flatten(td._sweep_layout(local, sep)),
                problem.nb_robots))
    return out


def _atomic_sum(src, keys, rows):
    """The sum the kernel replaced: ``index_add_`` into ``[rows, C]`` (the
    card's atomics)."""
    import torch
    out = torch.zeros((rows, src.shape[1]), dtype=src.dtype,
                      device=src.device)
    return out.index_add_(0, keys, src)


def _atomic_put(src, keys, rows):
    """The accumulating ``index_put_`` the dense sums used."""
    import torch
    out = torch.zeros((rows, src.shape[1]), dtype=src.dtype,
                      device=src.device)
    return out.index_put_((keys,), src, accumulate=True)


def _segment_sum_module():
    """``ops.segment_sum`` (None in a checkout older than it)."""
    try:
        from cslam_tpu_torch.ops import segment_sum
    except ImportError:
        return None
    return segment_sum


def phase_segment_sum(results, failures):
    """``csrc/segment_sum.cu`` against ``segment_sum_ref`` bit for bit at
    every shape of :func:`_segment_cases`, twice; the atomic sums it
    replaced (``index_add_`` for a per-node plan, ``index_put_(accumulate=
    True)`` for a compact one) run twice on the same inputs, whether they
    repeat bit for bit; times: the kernel and the atomic library call each
    replayed from a CUDA graph of back-to-back calls (``ms``,
    ``library_ms``: device time, as the step programs run them) and called
    eagerly (``*_eager``, CUDA events over 200 calls), the plain version
    (eager; it reads its widest segment on the host); the bound: the
    sources read once and the sums written once, at 3.35 TB/s (beside it,
    ``plan_bytes`` and ``bound_with_plan_ms``: the plan's int64 ``perm``,
    ``offsets`` and ``dest`` read once as well, a cost of this design);
    then MAC's dense-tier Laplacian (:func:`_laplacian_repeats`)."""
    import torch

    from cslam_tpu_torch.ops import segment_sum as ss
    out = results["segment_sum"] = {"cases": {}}
    torch.manual_seed(0)
    ss.reset_launches()
    for name, src, plan, rows, keys, dense_rows in _segment_cases():
        src = src.contiguous()
        got = ss.segment_sum(src, plan, rows)
        again = ss.segment_sum(src, plan, rows)
        ref = ss.segment_sum_ref(src, plan, rows)
        library = _atomic_put if plan.dest is not None else _atomic_sum
        atomic = [library(src, keys, dense_rows)
                  for _ in range(_SEGMENT_REPEATS)]
        _sync()
        err = float((got - ref).abs().max()) if got.numel() else 0.0
        # the function's bytes: the sources read once, the sums written
        # once; the plan's are this design's own
        nbytes = src.numel() * 4 + got.numel() * 4
        plan_bytes = sum(t.numel() * 8 for t in plan if t is not None)
        # fewer calls per graph where each call fills a large dense matrix
        calls = 100 if got.numel() * 4 < (64 << 20) else 10
        rec = {"sources": list(src.shape), "segments":
               plan.offsets.shape[0] - 1, "rows": dense_rows,
               "width": int(torch.max(plan.offsets[1:]
                                      - plan.offsets[:-1])),
               "bit_for_bit": bool(torch.equal(got, ref)),
               "max_abs_err": err,
               "kernel_repeats": bool(torch.equal(got, again)),
               "atomic_repeats": all(torch.equal(atomic[0], a)
                                     for a in atomic[1:]),
               "atomic_vs_kernel_max_abs_err": float(
                   (atomic[0] - got).abs().max()),
               "ms": _graph_call_ms(
                   lambda: ss.segment_sum(src, plan, rows), calls),
               "ms_eager": _time_ms(
                   lambda: ss.segment_sum(src, plan, rows), 200),
               "plain_ms": _time_ms(
                   lambda: ss.segment_sum_ref(src, plan, rows), 5, 1),
               "library_ms": _graph_call_ms(
                   lambda: library(src, keys, dense_rows), calls),
               "library_ms_eager": _time_ms(
                   lambda: library(src, keys, dense_rows), 200),
               **{k: v for k, v in _bound(0.0, nbytes, "fp32").items()
                  if k in ("bound_ms", "bound_by", "bytes")},
               "plan_bytes": plan_bytes,
               "bound_with_plan_ms": _bound(0.0, nbytes + plan_bytes,
                                            "fp32")["bound_ms"]}
        if not rec["bit_for_bit"]:
            failures.append(f"segment_sum {name}: kernel and plain version "
                            f"differ (max {err})")
        if not rec["kernel_repeats"]:
            failures.append(f"segment_sum {name}: two launches differ")
        out["cases"][name] = rec
        print(f"  segment_sum {name} " + json.dumps(rec))
    out["launches_in_phase"] = ss.device_launch_count()
    print(f"  segment_sum: {out['launches_in_phase']} launches counted on "
          "the device in this phase")
    out["laplacian_index_put"] = _laplacian_repeats(failures)


def _frontend_bank(rng, n):
    """A 131072 x 64 bank of ``n`` seeded non-unit rows and their inverse
    norms (padding rows zero), on the card."""
    import numpy as np
    import torch
    N, D = 131072, 64
    rows = (rng.standard_normal((n, D))
            * rng.uniform(0.5, 2.0, (n, 1))).astype(np.float32)
    bank = torch.zeros((N, D), dtype=torch.float32, device="cuda")
    bank[:n] = torch.from_numpy(rows).cuda()
    inv = torch.zeros(N, dtype=torch.float32, device="cuda")
    inv[:n] = 1.0 / bank[:n].norm(dim=1)
    return bank, inv


def _tile_scan_checks(bank, inv, n, rng, failures):
    """K2 against its plain version on the card, f32 and bf16 banks: every
    case of ``_scan_cases`` plus the main shape (B = 512, k = 10), all
    exact. Returns (largest max_abs_err, the case records)."""
    import numpy as np
    import torch
    cases = []
    q = torch.from_numpy(rng.standard_normal((512, bank.shape[1])).astype(
        np.float32)).cuda()
    for b in (bank, bank.to(torch.bfloat16)):
        rec, _ = _scan_case("tile_scan", "main shape", b, inv, n, q, 10,
                            failures)
        cases.append(rec)
        cases += _scan_cases("tile_scan", b, inv, n, rng, failures)
    return max(c["max_abs_err"] for c in cases), cases


def _tile_scan_times(bank, inv, n, q, k) -> dict:
    """K2, its plain version and the library pair at one shape, L2 flushed
    before each call, beside the bound for this run's inputs."""
    import torch

    from cslam_tpu_torch.ops import nns
    B, D = q.shape
    rows, inv_n = bank[:n], inv[:n]
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    flush = scratch.zero_                    # 256 MB > the 50 MB L2
    return {
        "B": B, "k": k,
        "ms": _time_cold_ms(
            lambda: nns.cosine_topk_fused(bank, inv, n, q, k), 20, flush),
        "plain_ms": _time_cold_ms(
            lambda: nns.cosine_topk_fused_ref(bank, inv, n, q, k), 3, flush,
            warmup=1),
        "library_ms": _time_cold_ms(
            lambda: torch.topk((q @ rows.T) * inv_n, k, dim=1), 20, flush),
        # dot products, x inv_norms; rows, norms and queries in, f32 + int64 out
        **_bound(2.0 * B * n * D + B * n,
                 n * D * 4 + n * 4 + B * D * 4 + B * k * 12, "float32")}


def phase_frontend(results, failures):
    import numpy as np
    import torch

    from cslam_tpu_torch.entry import entry, frontend_step
    from cslam_tpu_torch.models import make_global_descriptor, preprocess
    from cslam_tpu_torch.ops import highest_precision, nns
    from cslam_tpu_torch.ops.topk import cosine_topk

    params = {"frontend.global_descriptor_technique": "cosplace",
              "frontend.nn_checkpoint": "random",  # seeded golden weights
              "frontend.cosplace.backbone": "resnet18",
              "frontend.cosplace.descriptor_dim": 64,
              "frontend.image_crop_size": 376, "robot_id": 0}
    model = make_global_descriptor(params, device="cuda")
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (32, 480, 640, 3), dtype=np.uint8)
    out = {}

    # descriptors, B = 1 through the runtime's begin/finish and B = 32
    def embed_one(i):
        return model.compute_embedding_finish(
            model.compute_embedding_begin(frames[i]))
    embed_one(0)
    _sync()
    t0 = time.perf_counter()
    one = [embed_one(i) for i in range(len(frames))]
    out["embed_ms_per_image_b1"] = (time.perf_counter() - t0) * 1e3 / 32
    model.compute_embeddings(frames)
    t0 = time.perf_counter()
    for _ in range(5):
        batch = model.compute_embeddings(frames)
    out["embed_ms_per_image_b32"] = (time.perf_counter() - t0) * 1e3 / 160
    if not (batch.shape == (32, 64) and np.isfinite(batch).all()
            and np.allclose(np.linalg.norm(batch, axis=1), 1.0, atol=1e-4)):
        failures.append(f"frontend: bad descriptors {batch.shape}")
    out["b1_vs_b32_min_cosine"] = float(np.min(np.sum(
        np.stack(one) * batch, axis=1)))

    # the same model on the CPU (the plain convolutions), TF32 off on the card
    want = make_global_descriptor(params, device="cpu").compute_embeddings(
        frames[:4])
    got = highest_precision(model.compute_embeddings)(frames[:4])
    cos = np.sum(got * want, axis=1) / (np.linalg.norm(got, axis=1)
                                        * np.linalg.norm(want, axis=1))
    out["cuda_vs_cpu_min_cosine"] = float(cos.min())
    got = model.compute_embeddings(frames[:4])   # default flags (cuDNN TF32)
    out["cuda_tf32_default_vs_cpu_min_cosine"] = float(np.min(
        np.sum(got * want, axis=1)))
    if not cos.min() >= 0.9999:
        failures.append(f"frontend: CUDA vs CPU descriptor cosine "
                        f"{cos.min()} < 0.9999")
    netvlad = {**params, "frontend.global_descriptor_technique": "netvlad"}
    want = make_global_descriptor(netvlad, device="cpu").compute_embeddings(
        frames[:2])
    got = highest_precision(make_global_descriptor(
        netvlad, device="cuda").compute_embeddings)(frames[:2])
    out["netvlad_cuda_vs_cpu_min_cosine"] = float(np.min(np.sum(
        got * want, axis=1)))
    if not (got.shape == (2, 128)
            and out["netvlad_cuda_vs_cpu_min_cosine"] >= 0.9999):
        failures.append(f"frontend: NetVLAD CUDA vs CPU {got.shape}, "
                        f"cosine {out['netvlad_cuda_vs_cpu_min_cosine']}")

    # the entry twin at its own example shapes, on the default device
    fn, args = entry()
    desc, sims, idx = fn(*args)
    if not (desc.is_cuda and idx.shape == (1, 8)
            and bool(torch.isfinite(sims).all())):
        failures.append("frontend: entry() did not run on the card")

    # frontend_step at full width: the main path
    n = 100000
    bank, inv = _frontend_bank(rng, n)
    net = model.model
    launches = {"tile_scan": 0, "bank_scan": 0}
    steps = {}
    for B in (1, 32):
        images = preprocess.preprocess(frames[:B], 376, torch.device("cuda"))
        _sync()
        nns.tile_scan_launches = nns.launches = 0
        desc, sims, idx = frontend_step(net, images, bank, inv, n, 8)
        _sync()
        got_launches = nns.tile_scan_launches
        launches["tile_scan"] += got_launches
        launches["bank_scan"] += nns.launches
        print(f"  frontend_step B={B} (bank 131072x64, n={n}, k=8): "
              f"{got_launches} tile-scan launch(es)")
        if got_launches < 1:
            failures.append(f"frontend_step B={B}: K2 not launched")
        ref_v, ref_i = cosine_topk(bank, inv, n, desc, 8)
        if not torch.equal(idx, ref_i):
            failures.append(f"frontend_step B={B}: indices differ from "
                            "cosine_topk")
        err = float((sims - ref_v).abs().max())
        out[f"step_b{B}_vs_cosine_topk_max_abs_err"] = err
        if not err <= _VALUE_TOL:
            failures.append(f"frontend_step B={B}: values differ from "
                            f"cosine_topk by {err}")
        t0 = time.perf_counter()
        for _ in range(10):
            frontend_step(net, images, bank, inv, n, 8)
        _sync()
        out[f"step_b{B}_ms"] = (time.perf_counter() - t0) * 1e3 / 10
        out[f"search_b{B}_ms"] = _time_ms(
            lambda: nns.cosine_topk_fused(bank, inv, n, desc, 8), 20)
        steps[B] = images
    out["launches_main_path"] = launches
    print("  " + json.dumps(out))

    out["tile_scan_max_abs_err"], out["tile_scan_cases"] = (
        _tile_scan_checks(bank, inv, n, rng, failures))
    queries = {}
    for B, k in ((1, 8), (512, 10)):
        queries[B] = torch.from_numpy(rng.standard_normal(
            (B, bank.shape[1])).astype(np.float32)).cuda()
        timing = _tile_scan_times(bank, inv, n, queries[B], k)
        out[f"tile_scan_b{B}"] = timing
        print(f"  tile_scan B={B} k={k}: " + json.dumps(timing))

    # device-time breakdowns last: the profiler may slow what runs after it
    for B, images in steps.items():
        out[f"step_b{B}_profile"] = _device_profile(
            lambda: frontend_step(net, images, bank, inv, n, 8), 10)
        print(f"  frontend_step B={B} profile: "
              + json.dumps(out[f"step_b{B}_profile"]))
    for (B, q), k in zip(queries.items(), (8, 10)):
        timing = out[f"tile_scan_b{B}"]
        timing["profile"] = _device_profile(
            lambda: nns.cosine_topk_fused(bank, inv, n, q, k))
        timing["library_profile"] = _device_profile(
            lambda: torch.topk((q @ bank[:n].T) * inv[:n], k, dim=1))
        print(f"  tile_scan B={B} profile: " + json.dumps(timing["profile"])
              + " library: " + json.dumps(timing["library_profile"]))
    # K1 on the same bank at the bench batch and at a swarm-sized batch
    for B in (512, 8):
        q = queries[512][:B]
        out[f"bank_scan_b{B}_profile"] = _device_profile(
            lambda: nns.cosine_topk_scan(bank, n, q, 10))
        print(f"  bank_scan B={B} profile: "
              + json.dumps(out[f"bank_scan_b{B}_profile"]))
    results["frontend"] = out


def _solver_graphs():
    """The solvers' step-program sets (``utils.tier_graphs.StepGraphs``):
    the dense LM, the PCG-tier LM, the batched LM at both tiers, the
    distributed solve, MAC's dense and Woodbury Frank-Wolfe loops."""
    from cslam_tpu_torch.pgo import distributed, solver
    from cslam_tpu_torch.selection import mac
    sets = (solver.DENSE_GRAPHS, solver.PCG_GRAPHS,
            distributed.BATCHED_GRAPHS,
            getattr(distributed, "BATCHED_PCG_GRAPHS", None),
            getattr(distributed, "DIST_GRAPHS", None), mac.DENSE_FW_GRAPHS,
            mac.WOODBURY_FW_GRAPHS)
    return tuple(g for g in sets if g is not None)   # older checkouts


def _solver_graph_counts():
    """{set: {program: (captures, replays)}} of :func:`_solver_graphs`."""
    return {g.name: {p: (c["captures"], c["replays"])
                     for p, c in g.by_program.items()}
            for g in _solver_graphs()}


def _solver_graph_delta(before):
    """Captures and replays per program since ``before``, and their
    totals."""
    after = _solver_graph_counts()
    delta = {name: {p: {"captures": after[name][p][0] - before[name][p][0],
                        "replays": after[name][p][1] - before[name][p][1]}
                    for p in progs} for name, progs in after.items()}
    return {"by_program": delta,
            "captures": sum(d["captures"] for progs in delta.values()
                            for d in progs.values()),
            "replays": sum(d["replays"] for progs in delta.values()
                           for d in progs.values())}


class _Counters:
    """Counts, while it is entered, what the solvers do: MAC selections
    with their FW iterations, evaluations, LOBPCG calls, live and masked
    iterations and host reads (the loop state's own counters,
    ``MAC.last_loop``), LM solves with their LM and
    CG iterations (the solver's own device counters, returned with each
    result; under a CUDA graph the matvec runs only at capture) and the
    padded node count of each, PCG-tier solves with the host reads of
    each, host reads of CUDA tensors (``bool``, ``float``, ``int``,
    ``item``, ``tolist``, ``cpu``, and every wait on a CUDA event or
    stream: the solver's status reads are event waits), and the step
    programs' captures and replays. It wraps the functions from here,
    leaving the package as it is, and restores them on exit."""

    def __enter__(self):
        import torch

        from cslam_tpu_torch.pgo import solver
        from cslam_tpu_torch.selection import mac
        self.lobpcg_calls = self.lobpcg_iters = self.evaluations = 0
        self.lobpcg_masked = self.fw_iters = self.mac_host_reads = 0
        #: (tier, FW iterations, host reads) of each MAC selection
        self.selections = []
        self.lm_calls = self.lm_iters = self.pcg_solves = self.cg_iters = 0
        self.host_reads = self.coarse_failures = 0
        self.lm_nodes = []
        #: (host reads, LM iterations, CG iterations) of each PCG solve
        self.pcg_reads = []
        #: (rel_tol, LM iterations) of each LM solve, in order
        self.lm_solves = []
        #: poses of the last LM solve with rel_tol >= 1e-5 (in a GNC: the
        #: end of the graduation, before the final polish)
        self.held_poses = None
        self._graphs = _solver_graph_counts()
        self._saved = []

        def patch(owner, name, make):
            orig = getattr(owner, name)
            self._saved.append((owner, name, orig))
            setattr(owner, name, make(orig))

        def selection(orig):
            def run(m, *args, **kwargs):
                out = orig(m, *args, **kwargs)
                loop = m.last_loop
                self.lobpcg_calls += loop["lobpcg_calls"]
                self.lobpcg_iters += loop["lobpcg_iters"]
                self.lobpcg_masked += loop["lobpcg_masked"]
                self.evaluations += loop["evaluations"]
                self.fw_iters += loop["it"]
                self.mac_host_reads += loop["host_reads"]
                self.selections.append(("dense" if m._dense else "woodbury",
                                        loop["it"], loop["host_reads"]))
                return out
            return run

        def lm(orig):
            def run(g, *args, **kwargs):
                reads = self.host_reads
                res = orig(g, *args, **kwargs)
                self.lm_calls += 1
                self.lm_iters += res.iterations
                rel_tol = kwargs.get("rel_tol", 1e-7)
                self.lm_solves.append((rel_tol, res.iterations))
                if rel_tol >= 1e-5:
                    self.held_poses = res.poses
                self.cg_iters += res.cg_iterations
                self.coarse_failures += getattr(res, "coarse_failures", 0)
                self.lm_nodes.append(g.num_nodes)
                if g.num_nodes > solver._DENSE_SOLVE_MAX_NODES:
                    self.pcg_solves += 1
                    self.pcg_reads.append((self.host_reads - reads,
                                           res.iterations,
                                           res.cg_iterations))
                return res
            return run

        def read(orig):
            def run(t, *args, **kwargs):
                if t.is_cuda:
                    self.host_reads += 1
                return orig(t, *args, **kwargs)
            return run

        def wait(orig):
            def run(*args, **kwargs):
                self.host_reads += 1
                return orig(*args, **kwargs)
            return run

        patch(mac.MAC, "fw_subset_dispatch", selection)
        patch(solver, "lm_optimize", lm)
        for name in ("__bool__", "__float__", "__int__", "item", "tolist",
                     "cpu"):
            patch(torch.Tensor, name, read)
        patch(torch.cuda.Event, "synchronize", wait)
        patch(torch.cuda.Stream, "synchronize", wait)
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        self.graphs = _solver_graph_delta(self._graphs)
        return False

    def pcg_read_excess(self) -> list:
        """PCG-tier solves whose host reads exceed one per ``_CG_BLOCK``
        CG iterations plus two per LM iteration: (reads, bound)."""
        from cslam_tpu_torch.pgo import solver
        K = solver._CG_BLOCK
        return [(reads, cg / K + 2 * it) for reads, it, cg in self.pcg_reads
                if reads > cg / K + 2 * it]

    def mac_read_excess(self) -> list:
        """MAC selections whose host reads exceed the stated bound: one
        status read per FW iteration plus the last (Woodbury tier); on the
        dense tier also one eager eigensolve per evaluation (two per FW
        iteration and the initial rounding): (tier, reads, bound)."""
        out = []
        for tier, it, reads in self.selections:
            bound = it + 1 if tier == "woodbury" else 3 * it + 1
            if reads > bound:
                out.append((tier, reads, bound))
        return out

    def summary(self) -> dict:
        out = {"mac_selections": len(self.selections),
               "fw_iters": self.fw_iters,
               "mac_host_reads": self.mac_host_reads,
               "lobpcg_calls": self.lobpcg_calls,
               "lobpcg_iters": self.lobpcg_iters,
               "lobpcg_masked": self.lobpcg_masked,
               "evaluations": self.evaluations,
               "lm_calls": self.lm_calls, "lm_iters": self.lm_iters,
               "pcg_solves": self.pcg_solves, "cg_iters": self.cg_iters,
               "coarse_factor_failures": self.coarse_failures,
               "host_reads": self.host_reads,
               "pcg_solve_host_reads": sum(r for r, _, _ in self.pcg_reads)}
        graphs = getattr(self, "graphs", None)
        if graphs is not None:
            out.update(graph_captures=graphs["captures"],
                       graph_replays=graphs["replays"])
        return out


def _build_acm(nb_robots, nb_poses, nb_candidates, nb_fixed, rng, device):
    """``benchmarks/selection_bench.py``'s ACM (config-default MAC kwargs):
    one full-range fixed edge per robot pair pins the pose counts, then
    ``nb_fixed`` random fixed edges and ``nb_candidates`` random candidates
    between consecutive robots."""
    from cslam_tpu_torch.selection.acm import \
        AlgebraicConnectivityMaximization
    from cslam_tpu_torch.types import EdgeInterRobot
    acm = AlgebraicConnectivityMaximization(
        robot_id=0, max_nb_robots=nb_robots, device=device)
    for r0 in range(nb_robots - 1):
        acm.add_fixed_edge(EdgeInterRobot(
            r0, nb_poses - 1, r0 + 1, nb_poses - 1,
            float(rng.uniform(0.5, 1.0))))
    for _ in range(nb_fixed):
        r0 = int(rng.integers(0, nb_robots - 1))
        acm.add_fixed_edge(EdgeInterRobot(
            r0, int(rng.integers(0, nb_poses)), r0 + 1,
            int(rng.integers(0, nb_poses)), float(rng.uniform(0.5, 1.0))))
    for _ in range(nb_candidates):
        r0 = int(rng.integers(0, nb_robots - 1))
        acm.add_candidate_edge(EdgeInterRobot(
            r0, int(rng.integers(0, nb_poses)), r0 + 1,
            int(rng.integers(0, nb_poses)), float(rng.uniform(0.1, 1.0))))
    return acm


def _recorded_selection(acm, robots):
    """``select_candidates(5, in_range)`` on ``acm``, returning the selected
    edges and the MAC's own view of the round: the MAC, its fixed and
    candidate edges and the rounded selection."""
    seen = {}
    dispatch, finish = acm.run_mac_solver_dispatch, acm.run_mac_solver_finish

    def record_dispatch(fixed, cands, *args, **kwargs):
        seen.update(fixed=list(fixed), cands=list(cands), w_init=args[0],
                    k=args[1])
        seen["mac"], pending = dispatch(fixed, cands, *args, **kwargs)
        return seen["mac"], pending

    def record_finish(*args, **kwargs):
        seen["rounded"] = finish(*args, **kwargs)
        return seen["rounded"]
    acm.run_mac_solver_dispatch = record_dispatch
    acm.run_mac_solver_finish = record_finish
    try:
        sel = acm.select_candidates(5, {r: True for r in range(robots)})
    finally:
        del acm.run_mac_solver_dispatch, acm.run_mac_solver_finish
    return sel, seen


class _HostDrivenStages:
    """While entered, each LOBPCG stage of a graphed selection runs its
    captured body replayed from the host until the host reads its stop
    flag clear (``StepGraphs.run_while``'s plain version): the same
    graphs and kernels as the WHILE node, so the results must agree bit
    for bit."""

    def __enter__(self):
        from cslam_tpu_torch.utils import tier_graphs
        self._owner = tier_graphs._GraphLoop
        self._orig = self._owner.run_while

        def host_driven(loop, name, flag):
            while bool(loop.state[flag]):
                loop.run(name)
        self._owner.run_while = host_driven
        return self

    def __exit__(self, *exc):
        self._owner.run_while = self._orig


def _mac_graphed_vs_eager(mac, seen, max_iters, failures, tag):
    """The recorded round's selection again three ways: replayed from its
    captured programs (each LOBPCG stage a WHILE node), the same with each
    stage's body replayed from the host until it reads the stop flag
    clear (:class:`_HostDrivenStages`), and launched eagerly (the same
    programs one by one). Limits: graphed and host-driven stages pick the
    same edges with the same relaxed iterate and dual bound, bit for bit,
    and the same FW iterations, LOBPCG stages and iterations; graphed and
    eager the same edges and FW iterations (eager's kernels differ from
    the captured ones, so LOBPCG's own threshold decisions, its
    convergence test and the residual gate, may fall otherwise: its
    counts are printed). Host reads within their bound; times of each."""
    import numpy as np
    out = {}
    runs = [("graphed", False, contextlib.nullcontext)]
    if not mac._dense:
        runs.append(("host_driven", False, _HostDrivenStages))
    runs.append(("eager", True, contextlib.nullcontext))
    for label, eager, ctx in runs:
        _sync()
        t0 = time.perf_counter()
        with ctx():
            sel, w, dual = mac.fw_subset(seen["w_init"], seen["k"],
                                         max_iters=max_iters, eager=eager)
        _sync()
        out[label] = (sel, w, dual, dict(mac.last_loop),
                      (time.perf_counter() - t0) * 1e3)
    g, e = out["graphed"], out["eager"]
    counts = ("it", "lobpcg_calls", "lobpcg_iters", "lobpcg_masked",
              "evaluations")
    rec = {"same_edges": bool(np.array_equal(g[0], e[0])),
           "fw_iters": [g[3]["it"], e[3]["it"]],
           "lobpcg_calls": [g[3]["lobpcg_calls"], e[3]["lobpcg_calls"]],
           "lobpcg_iters": [g[3]["lobpcg_iters"], e[3]["lobpcg_iters"]],
           "max_abs_w_diff": float(np.abs(g[1] - e[1]).max()),
           "dual_rel_diff": abs(g[2] / e[2] - 1.0) if e[2] else None,
           "graphed_ms": g[4], "eager_ms": e[4], "loop": g[3]}
    bound = (g[3]["it"] + 1 if not mac._dense else 3 * g[3]["it"] + 1)
    rec["host_read_bound"] = bound
    if not rec["same_edges"] or g[3]["it"] != e[3]["it"]:
        failures.append(f"{tag}: graphed and eager selections differ "
                        f"(edges equal {rec['same_edges']}, FW iterations "
                        f"{rec['fw_iters']})")
    if "host_driven" in out:
        h = out["host_driven"]
        rec["host_driven"] = {
            "same_bits": bool(np.array_equal(g[0], h[0])
                              and np.array_equal(g[1], h[1])
                              and g[2] == h[2]),
            **{k: h[3][k] for k in counts}, "ms": h[4]}
        if not rec["host_driven"]["same_bits"] or any(
                g[3][k] != h[3][k] for k in counts):
            failures.append(f"{tag}: LOBPCG stages as while loops and "
                            f"driven from the host differ: "
                            f"{ {k: g[3][k] for k in counts} } vs "
                            f"{rec['host_driven']}")
    if g[3]["host_reads"] > bound:
        failures.append(f"{tag}: {g[3]['host_reads']} host reads in a "
                        f"selection, bound {bound}")
    return rec


def _symmetric_cases(rng):
    """Random symmetric float32 matrices, n = 4 and 12 (LOBPCG's SVQB and
    Rayleigh-Ritz sizes at block 4) and 16, with spread, clustered and
    repeated eigenvalues and a wide range."""
    import numpy as np
    out = []
    for n in (4, 12, 16):
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        for lam in (rng.standard_normal(n) * 10.0,
                    1.0 + 1e-4 * rng.standard_normal(n),
                    np.repeat([3.0, -1.0], (n + 1) // 2)[:n],
                    np.logspace(-6, 5, n)):
            out.append(((Q * lam) @ Q.T).astype(np.float32))
    return out


#: the small eigensolver's limits against ``torch.linalg.eigh`` on the card:
#: eigenvalues within this many float32 eps of max |lambda| (the plain
#: version's own error is a few eps |A|, the kernel's float64 Jacobi
#: rounds once), eigenvectors |<v, v_plain>| >= 1 - _EIGVEC_TOL where the
#: gap to the neighbours is at least _EIGVEC_GAP max |lambda|
_EIGVAL_EPS = 16
_EIGVEC_TOL = 1e-4
_EIGVEC_GAP = 1e-3


def _eigh_kernel_ops(n: int, sweeps: int) -> float:
    """A diagnostic, not a bound: the eigh kernel's own float64 operations
    on one ``n x n`` matrix that rotated ``sweeps`` sweeps
    (``csrc/small_eigh.cu``): per sweep N - 1 steps (N = n rounded up to
    even), each N/2 rotations of about 16 operations and N^2 entries of A
    (4 coefficient products, 4 products, 3 sums) and of V (2 products, 1
    sum); the off-norm test, 2 N^2 per sweep, once more at the end."""
    N = n + n % 2
    return float(sweeps * (N - 1) * (N // 2 * 16 + N * N * 14)
                 + (sweeps + 1) * 2 * N * N)


def _svd_cases(mac, rng):
    """The SVD kernel's cases: the 4 x 4 top blocks that ``_extend_basis``
    decomposes in one whole eager Woodbury selection of ``mac`` (the same
    programs as the graphed one, launched one by one, so that each block
    passes through Python; the first 64), seeded blocks at n = 1 .. 16
    (Gaussian and graded singular values) and rank-deficient blocks (a zero
    column, the completion; two equal columns)."""
    import numpy as np
    import torch

    from cslam_tpu_torch.ops import small_linalg as sl
    recorded, svd0 = [], sl.svd

    def rec_svd(A):
        if len(recorded) < 64:
            recorded.append(A.detach().clone())
        return svd0(A)
    sl.svd = rec_svd
    try:
        mac.fw_subset(np.zeros(mac._m), 5, max_iters=20, eager=True)
    finally:
        sl.svd = svd0
    seeded = []
    for n in range(1, 17):
        P, _ = np.linalg.qr(rng.standard_normal((n, n)))
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        seeded += [rng.standard_normal((n, n)),
                   (P * np.logspace(-6, 0, n)) @ Q.T]
    zero = rng.standard_normal((4, 4))
    zero[:, 3] = 0.0
    twin = rng.standard_normal((6, 6))
    twin[:, 4] = twin[:, 1]

    def cuda(mats):
        return [torch.from_numpy(a.astype(np.float32)).cuda() for a in mats]
    return {"selection": recorded, "random": cuda(seeded),
            "rank_deficient": cuda([zero, twin])}


def _small_svd_checks(mac, rng, failures):
    """The SVD kernel on the card, one call per matrix as LOBPCG calls it,
    on :func:`_svd_cases`: bit for bit against ``svd_jacobi_ref`` (its
    arithmetic in torch float64 on the CPU copy, which also counts each
    matrix's sweeps; a mismatch fails with no limit) and within the limits
    against ``torch.linalg.svd`` of the input in float64 on the card. The
    float32 library call's own distance from that reference, and the
    kernel's from the float32 call (the limits held on the recorded
    blocks), are kept beside them: at n = 16 the float32 call is the less
    accurate of the two. Returns the record and a recorded 4 x 4 block for
    the times."""
    import torch

    from cslam_tpu_torch.ops import small_linalg as sl
    eps = float(torch.finfo(torch.float32).eps)
    # an older checkout has no mirror: its fields are then null, not a pass
    has_mirror = hasattr(sl, "svd_jacobi_ref")
    out, sweeps_of = {}, {}
    cases = _svd_cases(mac, rng)

    def errors(U, S, Vh, ref):
        """|S - S_ref| in float32 eps of max sigma_ref, and max |U Vh -
        (U Vh)_ref| where sigma_min > 1e-3 sigma_max (else 0)."""
        Ur, Sr, Vhr = (x.double() for x in ref)
        top = max(float(Sr.max()), 1e-30)
        polar = (float((U.double() @ Vh.double() - Ur @ Vhr).abs().max())
                 if float(Sr.min()) > 1e-3 * top else 0.0)
        return float((S.double() - Sr).abs().max()) / (eps * top), polar

    for name, mats in cases.items():
        svd_err = svd_rel = polar_err = mirror_err = 0.0
        f32_rel = f32_polar = lib_rel = lib_polar = 0.0
        mismatches, sweeps = 0, []
        for A in mats:
            U, S, Vh = sl.svd(A)
            ref64 = torch.linalg.svd(A.double())
            ref32 = sl.svd_ref(A)
            svd_err = max(svd_err, float((S.double() - ref64[1]).abs().max()))
            rel, polar = errors(U, S, Vh, ref64)
            svd_rel, polar_err = max(svd_rel, rel), max(polar_err, polar)
            rel, polar = errors(U, S, Vh, ref32)
            f32_rel, f32_polar = max(f32_rel, rel), max(f32_polar, polar)
            rel, polar = errors(*ref32, ref64)
            lib_rel, lib_polar = max(lib_rel, rel), max(lib_polar, polar)
            if not has_mirror:
                continue
            *mirror, sw = sl.svd_jacobi_ref(A.cpu(), return_sweeps=True)
            sweeps.append(int(sw))
            sweeps_of[id(A)] = int(sw)
            got = [x.cpu() for x in (U, S, Vh)]
            if not all(torch.equal(g, m) for g, m in zip(got, mirror)):
                mismatches += 1
                mirror_err = max(mirror_err, *(
                    float((g - m).abs().nan_to_num(float("inf")).max())
                    for g, m in zip(got, mirror)))
        out[name] = {
            "matrices": len(mats), "max_abs_err": svd_err,
            "max_err_in_eps_of_max_sigma": svd_rel,
            "max_abs_polar_err": polar_err,
            "vs_float32_library": {"max_err_in_eps_of_max_sigma": f32_rel,
                                   "max_abs_polar_err": f32_polar},
            "float32_library_vs_float64": {
                "max_err_in_eps_of_max_sigma": lib_rel,
                "max_abs_polar_err": lib_polar},
            "mirror_mismatches": mismatches if has_mirror else None,
            "mirror_max_abs_err": mirror_err if has_mirror else None,
            "sweeps": [min(sweeps), max(sweeps)] if sweeps else None,
            "sweeps_mean": sum(sweeps) / len(sweeps) if sweeps else None}
        # limits: singular values as the eigenvalues; the polar factor U Vh
        # (what the basis extension uses) within 1e-4 where the block is
        # well conditioned; on the main path's blocks also against the
        # float32 call
        if svd_rel > _EIGVAL_EPS or polar_err > 1e-4 or (
                name == "selection"
                and (f32_rel > _EIGVAL_EPS or f32_polar > 1e-4)):
            failures.append(f"small svd on {name}: {out[name]}")
        # the same arithmetic in IEEE float64 on both sides: no limit
        if mismatches:
            failures.append(f"small svd on {name}: {mismatches} of "
                            f"{len(mats)} matrices differ from "
                            f"svd_jacobi_ref, by up to {mirror_err}")
    if not cases["selection"]:
        failures.append("small svd: the selection decomposed no block")
    groups = list(out.values())
    out.update(
        matrices=sum(g["matrices"] for g in groups),
        max_abs_err=max(g["max_abs_err"] for g in groups),
        mirror_mismatches=(sum(g["mirror_mismatches"] for g in groups)
                           if has_mirror else None),
        sweeps=out["selection"]["sweeps"],
        sweeps_mean=out["selection"]["sweeps_mean"])
    B4 = (cases["selection"] or [m for m in cases["random"]
                                 if m.shape[-1] == 4])[0]
    out["timed_block_sweeps"] = sweeps_of.get(id(B4))
    return out, B4


def _small_linalg_checks(mac, rounded, failures):
    """The small-eigensolver kernels against their plain versions on the
    card. The eigh kernel on the Rayleigh-Ritz (12 x 12) and SVQB (4 x 4)
    matrices of one real Woodbury evaluation of ``mac`` (recorded from its
    eager run) and on random symmetric matrices with clustered and
    repeated eigenvalues: bit for bit against ``eigh_jacobi_ref`` (its
    arithmetic in torch float64, run on the CPU copy of the same input; it
    also gives the sweeps each matrix took) and within the limits below
    against ``torch.linalg.eigh``. The SVD kernel as
    :func:`_small_svd_checks` holds it. Then the times of the kernels, the
    plain versions and the library calls (``torch.linalg.eigh`` /
    ``svd``), CUDA events, at batch 1, and the kernels' device times
    (the SVD's also at batch 1,024, one warp per matrix); the eigh bounds
    count this run's sweeps."""
    import numpy as np
    import torch

    from cslam_tpu_torch.ops import small_linalg as sl
    eigh_in, eigh0 = [], sl.eigh_descending

    def rec_eigh(A):
        eigh_in.append(A.detach().clone())
        return eigh0(A)
    sl.eigh_descending = rec_eigh
    try:
        mac.evaluate_objective(rounded)
    finally:
        sl.eigh_descending = eigh0
    rng = np.random.default_rng(11)
    cases = {"rayleigh_ritz": [a for a in eigh_in if a.shape[-1] == 12][:64],
             "svqb": [a for a in eigh_in if a.shape[-1] == 4][:64],
             "random": [torch.from_numpy(a).cuda()
                        for a in _symmetric_cases(rng)]}
    eps = float(torch.finfo(torch.float32).eps)
    # an older checkout has no mirror: its fields are then null, not a pass
    has_mirror = hasattr(sl, "eigh_jacobi_ref")
    out, sweeps_of = {}, {}
    for name, mats in cases.items():
        val_err = worst_val = mirror_err = 0.0
        vec_min, n_vec, mismatches, sweeps = 1.0, 0, 0, []
        for A in mats:
            w, V = sl.eigh_descending(A)
            wr, Vr = sl.eigh_descending_ref(A)
            if has_mirror:
                wm, Vm, sw = sl.eigh_jacobi_ref(A.cpu(), return_sweeps=True)
                sweeps.append(int(sw))
                sweeps_of[id(A)] = int(sw)
            if has_mirror and not (torch.equal(w.cpu(), wm)
                                   and torch.equal(V.cpu(), Vm)):
                mismatches += 1
                mirror_err = max(mirror_err,
                                 float((w.cpu() - wm).abs().max()),
                                 float((V.cpu() - Vm).abs().max()))
            scale = max(float(wr.abs().max()), 1e-30)
            err = float((w - wr).abs().max())
            worst_val = max(worst_val, err / (eps * scale))
            val_err = max(val_err, err)
            n = A.shape[-1]
            for j in range(n):
                gaps = [abs(float(wr[j] - wr[i])) for i in (j - 1, j + 1)
                        if 0 <= i < n]
                if all(gp >= _EIGVEC_GAP * scale for gp in gaps):
                    vec_min = min(vec_min, abs(float(V[:, j] @ Vr[:, j])))
                    n_vec += 1
        out[name] = {"matrices": len(mats), "max_abs_err": val_err,
                     "max_err_in_eps_of_max_lambda": worst_val,
                     "min_vector_overlap": vec_min, "vectors_held": n_vec,
                     "mirror_mismatches": mismatches if has_mirror else None,
                     "mirror_max_abs_err": mirror_err if has_mirror else None,
                     "sweeps": [min(sweeps), max(sweeps)] if sweeps else None,
                     "sweeps_mean": (sum(sweeps) / len(sweeps)
                                     if sweeps else None)}
        if worst_val > _EIGVAL_EPS or vec_min < 1.0 - _EIGVEC_TOL:
            failures.append(f"small eigh on {name}: {out[name]}")
        # the same arithmetic in IEEE float64 on both sides: no limit
        if mismatches:
            failures.append(f"small eigh on {name}: {mismatches} of "
                            f"{len(mats)} matrices differ from "
                            f"eigh_jacobi_ref, by up to {mirror_err}")
    out["svd"], B4 = _small_svd_checks(mac, rng, failures)
    A12 = (cases["rayleigh_ritz"] or cases["random"])[0]
    A4 = (cases["svqb"] or cases["random"])[0]
    times = {}
    for label, fn in (
            ("eigh12", lambda: sl.eigh_descending(A12)),
            ("eigh12_plain", lambda: sl.eigh_descending_ref(A12)),
            ("eigh12_library", lambda: torch.linalg.eigh(A12)),
            ("eigh4", lambda: sl.eigh_descending(A4)),
            ("eigh4_plain", lambda: sl.eigh_descending_ref(A4)),
            ("eigh4_library", lambda: torch.linalg.eigh(A4)),
            ("svd4", lambda: sl.svd(B4)),
            ("svd4_plain", lambda: sl.svd_ref(B4)),
            ("svd4_library", lambda: torch.linalg.svd(B4))):
        times[label] = _time_ms(fn, 200)
    out["times_ms"] = times
    # the kernels' own device time per call (the eager calls above are
    # host-bound below about 0.05 ms)
    out["device_ms"] = {label: _device_profile(fn, 50).get("device_ms")
                        for label, fn in (
                            ("eigh12", lambda: sl.eigh_descending(A12)),
                            ("eigh4", lambda: sl.eigh_descending(A4)),
                            ("svd4", lambda: sl.svd(B4)))}
    B4_1024 = B4.expand(1024, 4, 4).contiguous()
    out["device_ms"]["svd4_batch1024"] = _device_profile(
        lambda: sl.svd(B4_1024), 20).get("device_ms")
    out["graph_ms"] = {"svd4": _graph_call_ms(lambda: sl.svd(B4))}
    # bytes: the matrix read once, the outputs written once; operations:
    # 9 n^3, the usual count of a symmetric eigendecomposition with its
    # vectors (an SVD: 14 n^3 at this size), at the FP32 rate (float32 in
    # and out). The kernel's own float64 work at this run's sweeps is a
    # separate diagnostic (null without the mirror that counts the sweeps)
    out["eigh12_bound"] = _bound(9 * 12 ** 3, 4 * (2 * 144 + 12), "fp32")
    out["eigh4_bound"] = _bound(9 * 4 ** 3, 4 * (2 * 16 + 4), "fp32")
    for n, A in ((12, A12), (4, A4)):
        sw = sweeps_of.get(id(A))
        out[f"eigh{n}_kernel_work"] = {
            "sweeps": sw,
            "fp64_ops": None if sw is None else _eigh_kernel_ops(n, sw)}
    out["svd4_bound"] = _bound(14 * 4 ** 3, 4 * (3 * 16 + 4), "fp32")
    print("  small linalg " + json.dumps(out))
    return out


@functools.lru_cache(maxsize=None)
def _ref_stage_programs():
    """The Woodbury tier's first LOBPCG stage as it ran before the apply
    lost its triangular solves: the setup keeps the capacitance factor
    (not ``Z``) in the state, and each apply of the body runs
    ``fiedler.woodbury_inverse_ref``'s two triangular solves. A
    :class:`StepGraphs` of its own, so that ``--phases mac_calls`` times
    the stage both ways in one call; ``None`` in a checkout without the
    plain apply."""
    import torch

    from cslam_tpu_torch.ops import fiedler as fd
    from cslam_tpu_torch.ops.lobpcg import lobpcg_init
    from cslam_tpu_torch.selection import mac as mac_mod
    from cslam_tpu_torch.utils.tier_graphs import StepGraphs
    if not hasattr(fd, "woodbury_inverse_ref"):
        return None

    def apply(s, o):
        return fd.woodbury_inverse_ref(o["Tinv"], o["U"], o["Y"], s["chol"])

    def setup(s, o, warm_ritz=False, lobpcg_iters=48, short_iters=14, **_):
        lr_w = torch.cat([o["lr_w_fixed"], s["w"] * o["cw"]])
        chol = fd.woodbury_factor(o["G"], lr_w, o["cinv_sigma"])
        st = lobpcg_init(apply({"chol": chol}, o),
                         s["aux"] if warm_ritz else o["x0"],
                         min(short_iters, lobpcg_iters), enabled=s["live"])
        return {"lr_w": lr_w, "chol": chol,
                **{"l" + k: v for k, v in st.items()}}

    def body(s, o, block=1, **_):
        return mac_mod._lobpcg_iterations(s, apply(s, o), block)
    return StepGraphs("mac_woodbury_ref", {
        "init": mac_mod._fw_init, "setup": setup, "lobpcg": body})


#: the apply against its plain version: float32 eps of max |Tinv x| (both
#: forms subtract terms of that size from each other; 5 measured on the
#: CPU, tests/test_torch_small_linalg.py)
_APPLY_EPS = 32


def _apply_check(mac, loop, failures, tag) -> dict:
    """The new apply against ``woodbury_inverse_ref`` on this stage's
    operator (the factor of the state's weights) at 4 and 12 columns (the
    applies LOBPCG makes), with the limit; each apply's CUDA-event time."""
    import torch

    from cslam_tpu_torch.ops import fiedler as fd
    from cslam_tpu_torch.ops import highest_precision
    pre = mac._pre
    lr_w, = loop.take("lr_w")
    chol = fd.woodbury_factor(pre["G"], lr_w, mac._cinv_sigma)
    args = (pre["Tinv"], pre["U"], pre["Y"], chol)
    new, ref = fd.woodbury_inverse(*args), fd.woodbury_inverse_ref(*args)
    gen = torch.Generator("cuda").manual_seed(0)
    eps = float(torch.finfo(torch.float32).eps)
    rec = {}
    for k in (4, 12):
        x = torch.randn((mac._P, k), device="cuda", generator=gen)
        a, b = highest_precision(lambda: (new(x), ref(x)))()
        scale = float((pre["Tinv"] @ x).abs().max())
        err = float((a - b).abs().max())
        rec[f"k{k}"] = {
            "max_abs_err": err, "err_in_eps_of_max_tinv_x": err / (
                eps * scale),
            "apply_ms": _time_ms(highest_precision(lambda: new(x)), 20),
            "apply_ref_ms": _time_ms(highest_precision(lambda: ref(x)), 20)}
        if not err <= _APPLY_EPS * eps * scale:
            failures.append(f"{tag}: the apply and woodbury_inverse_ref "
                            f"{err} apart at {k} columns, "
                            f"{err / (eps * scale):.1f} eps of max "
                            f"|Tinv x| (limit {_APPLY_EPS})")
    return rec


def _lobpcg_stage_times(mac, failures, reps=5):
    """One LOBPCG stage of a Woodbury evaluation of ``mac`` (the first,
    from the start block, at w = 0.3) four ways: as one CUDA graph while
    loop (``StepGraphs.run_while``, the main path); its captured body
    replayed from the host until the host reads the stop flag clear (the
    while loop's plain version: the same graph, one read per iteration);
    the body replayed the known number of times with no read; and eagerly
    (the programs launched one by one). Then the same stage as it ran
    before the apply lost its triangular solves (:func:`_ref_stage_programs`,
    its while loop), the apply against that plain one
    (:func:`_apply_check`), and each form's state bytes (``Z`` or the
    factor) and graph pool bytes. CUDA-event ms, iterations, the Ritz
    values' differences, the bound of the stage's bytes, and last the
    device profile of the setup and the body replayed, with its triangular
    solves' share (cuBLAS ``trsm`` kernels), overall and in the body alone.
    Limits: the while loop and its plain version stop at the same
    iteration with Ritz values within 4 float32 eps of max |theta| (the
    same kernels: they should agree bit for bit). Eager's kernels differ,
    and so do the older form's, so their iterations and Ritz values are
    printed, not held."""
    import numpy as np
    import torch

    from cslam_tpu_torch.ops import fiedler as fd
    from cslam_tpu_torch.selection import mac as mac_mod
    from cslam_tpu_torch.utils import tier_graphs
    w0 = np.zeros(mac._E, np.float32)
    w0[:mac._m] = 0.3
    ops = mac._operands(w0, 5, 20, 1e-8)
    res = {}

    def timed(loop, fn):
        times = []
        for _ in range(reps):
            loop.run("setup")
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            _sync()
            times.append(start.elapsed_time(stop))
        return float(np.median(times))

    def result(loop, ms):
        return ms, loop.take("ltheta")[0].clone(), int(loop.take("li")[0])

    def profiles(loop, iters):
        def replays():
            for _ in range(iters):
                loop.run("lobpcg")

        def stage():
            # the body replayed: the profiler does not see the kernels
            # inside a WHILE node's body
            loop.run("setup")
            replays()
        return replays, _device_profile(stage, 3), _device_profile(
            replays, 3)
    static = mac._woodbury_static()
    graphs = mac_mod.WOODBURY_FW_GRAPHS
    pool0 = graphs.pool_bytes
    tag = f"LOBPCG stage at (P, E) = ({mac._P}, {mac._E})"
    with graphs.solve("cuda", ops, **static) as loop:
        loop.run("init")
        # the while loop first: it captures the body with its cudaGraph_t
        res["while"] = result(loop, timed(loop, lambda: loop.run_while(
            "lobpcg", "lactive")))

        def host_driven():
            while bool(loop.state["lactive"]):
                loop.run("lobpcg")
        res["host"] = result(loop, timed(loop, host_driven))
        iters = res["while"][2]
        replays, profile, body_profile = profiles(loop, iters)
        replayed_ms = timed(loop, replays)
        loop.run("setup")
        apply = (_apply_check(mac, loop, failures, tag)
                 if hasattr(fd, "woodbury_inverse_ref") else None)
        z_bytes = (loop.state["Z"].numel() * 4 if "Z" in loop.state
                   else None)
    pool_bytes = graphs.pool_bytes - pool0
    with graphs.solve("cuda", ops, eager=True, **static) as loop:
        loop.run("init")
        res["eager"] = result(loop, timed(loop, lambda: loop.run_while(
            "lobpcg", "lactive")))
    ref, ref_graphs = None, _ref_stage_programs()
    if ref_graphs is not None:
        pool0 = ref_graphs.pool_bytes
        # the plain apply also reads U, which the main path's loop lacks
        with ref_graphs.solve("cuda", dict(ops, U=mac._pre["U"]),
                              **static) as loop:
            loop.run("init")
            ms, theta_ref, it_ref = result(loop, timed(
                loop, lambda: loop.run_while("lobpcg", "lactive")))
            _, ref_profile, ref_body = profiles(loop, it_ref)
            ref = {"ms": ms, "iterations": it_ref,
                   "max_abs_err": float((res["while"][1]
                                         - theta_ref).abs().max()),
                   "chol_bytes": loop.state["chol"].numel() * 4,
                   "pool_bytes": ref_graphs.pool_bytes - pool0,
                   "profile": ref_profile,
                   "body_trsm_ms": ref_body.get("trsm_kernel_ms"),
                   "body_device_ms": ref_body.get("device_ms")}
    P, M1 = mac._P, mac._pre["U"].shape[1]
    eps = float(torch.finfo(torch.float32).eps)
    theta = res["while"][1]
    scale = eps * max(float(theta.abs().max()), 1e-30)
    err = float((theta - res["host"][1]).abs().max())
    err_eager = float((theta - res["eager"][1]).abs().max())
    # each iteration applies B^-1 twice; each apply reads Tinv once and Z
    # twice (the plain form: Tinv, U, Y and the factor)
    per_iter = 2 * 4 * (P * P + 2 * P * M1)
    per_iter_ref = 2 * 4 * (P * P + 2 * P * M1 + M1 * M1)
    rec = {"P": P, "E": mac._E, "M1": M1, "ms": res["while"][0],
           "plain_ms": res["host"][0], "body_replayed_ms": replayed_ms,
           "eager_ms": res["eager"][0],
           "iterations": [res["while"][2], res["host"][2]],
           "max_abs_err": err, "max_err_in_eps_of_max_theta": err / scale,
           "eager_iterations": res["eager"][2],
           "eager_max_abs_err": err_eager,
           "eager_err_in_eps_of_max_theta": err_eager / scale,
           **_bound(0.0, per_iter * res["while"][2], "fp32"),
           "bound_ref_ms": _bound(0.0, per_iter_ref * res["while"][2],
                                  "fp32")["bound_ms"],
           "z_bytes": z_bytes, "pool_bytes": pool_bytes,
           "shared_pool_bytes": tier_graphs.pool_bytes("cuda"),
           "body_trsm_ms": body_profile.get("trsm_kernel_ms"),
           "body_device_ms": body_profile.get("device_ms"),
           "apply": apply, "before": ref, "profile": profile}
    print("  LOBPCG stage while loop " + json.dumps(rec))
    if rec["iterations"][0] != rec["iterations"][1]:
        failures.append(f"{tag}: while loop and host-driven iterations "
                        f"{rec['iterations']}")
    if not rec["max_err_in_eps_of_max_theta"] <= 4:
        failures.append(f"{tag}: Ritz values of the while loop and the "
                        f"host-driven stage {err} apart, "
                        f"{rec['max_err_in_eps_of_max_theta']:.1f} eps of "
                        f"max |theta| (limit 4)")
    if z_bytes is not None and rec["body_trsm_ms"]:
        failures.append(f"{tag}: {rec['body_trsm_ms']} ms of triangular "
                        f"solves in the LOBPCG body")
    return rec


def _wall_ms(fn, iters: int = 10) -> float:
    """Host wall ms per call of ``fn`` (after one warm call), the device
    drained before and after."""
    import torch
    fn()
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync()
    return (time.perf_counter() - t0) * 1e3 / iters


def _call_mac(P, E, rng):
    """A MAC at pose tier ``P`` (``frontend.mac_p_floor`` = P, the other
    keywords config defaults) over a 4-robot graph of 3P/4 poses (chains,
    a loop between consecutive robots' last poses, P/8 random loops) with
    ``E`` random candidates. Built only through the MAC surface that every
    checkout since the Woodbury tier has, so that ``--phases mac_calls``
    measures an older checkout too."""
    from cslam_tpu_torch.selection.mac import MAC, mac_kwargs_from_params
    from cslam_tpu_torch.types import Edge
    per = P * 3 // 16
    n = 4 * per

    def pairs(count):
        out = []
        while len(out) < count:
            i, j = (int(x) for x in rng.integers(0, n, 2))
            if abs(i - j) > 1:
                out.append((i, j))
        return out
    fixed = [Edge(r * per + i, r * per + i + 1, 1.0)
             for r in range(4) for i in range(per - 1)]
    fixed += [Edge(r * per + per - 1, (r + 1) * per + per - 1, 0.8)
              for r in range(3)]
    fixed += [Edge(i, j, float(rng.uniform(0.5, 1.0)))
              for i, j in pairs(P // 8)]
    cands = [Edge(i, j, float(rng.uniform(0.1, 1.0))) for i, j in pairs(E)]
    return MAC(fixed, cands, n, device="cuda",
               **mac_kwargs_from_params({"frontend.mac_p_floor": P}))


def _call_record(fn, iters=10):
    """Wall ms per call, then device ms, kernels, host reads and top
    kernels per call (``torch.profiler``)."""
    rec = {"wall_ms": _wall_ms(fn, iters)}
    prof = _device_profile(fn, iters)
    rec.update({k: prof.get(k) for k in (
        "device_ms", "kernels_per_call", "dtoh_copies_per_call",
        "host_syncs_per_call", "top_kernels")})
    return rec


def _selection_ms(mac, repeats=3) -> dict:
    import numpy as np
    w0 = np.zeros(mac._m)
    mac.fw_subset(w0, 5, max_iters=20)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        mac.fw_subset(w0, 5, max_iters=20)
        times.append((time.perf_counter() - t0) * 1e3)
    return {"selection_ms": times, "fw_iters": mac.last_fw_iters}


def _selection_host_split(mac) -> dict:
    """Where the host's time goes in one graphed selection of ``mac`` (20
    FW iterations at most, budget 5): program replays, while-loop
    launches, status waits (the reads) and eager eigensolves, beside the
    wall."""
    import numpy as np
    import torch

    from cslam_tpu_torch.utils import tier_graphs
    w0 = np.zeros(mac._m)
    mac.fw_subset(w0, 5, max_iters=20)
    _sync()
    spent = {"run": 0.0, "run_while": 0.0, "wait": 0.0, "eigh": 0.0}
    saved = []
    for owner, name, key in ((tier_graphs._GraphLoop, "run", "run"),
                             (tier_graphs._GraphLoop, "run_while",
                              "run_while"),
                             (tier_graphs._Status, "wait", "wait"),
                             (torch.linalg, "eigh", "eigh")):
        orig = getattr(owner, name)
        saved.append((owner, name, orig))

        def timed(*args, _orig=orig, _key=key, **kwargs):
            t0 = time.perf_counter()
            try:
                return _orig(*args, **kwargs)
            finally:
                spent[_key] += time.perf_counter() - t0
        setattr(owner, name, timed)
    try:
        t0 = time.perf_counter()
        mac.fw_subset(w0, 5, max_iters=20)
        _sync()
        wall = time.perf_counter() - t0
    finally:
        for owner, name, orig in reversed(saved):
            setattr(owner, name, orig)
    return {"P": mac._P, "E": mac._E, "wall_ms": wall * 1e3,
            **{f"{k}_ms": v * 1e3 for k, v in spent.items()},
            "loop": dict(mac.last_loop)}


def _program_profiles(mac) -> dict:
    """Device ms and CUDA kernels of one replay of each Frank-Wolfe
    program of ``mac``'s tier (captured by a selection first)."""
    import numpy as np

    from cslam_tpu_torch.selection import mac as mac_mod
    mac.fw_subset(np.zeros(mac._m), 5, max_iters=20)
    w0 = np.zeros(mac._E, np.float32)
    w0[:mac._m] = 0.3
    ops = mac._operands(w0, 5, 20, 1e-8)
    out = {"P": mac._P, "E": mac._E}
    if mac._dense:
        graphs, static = mac_mod.DENSE_FW_GRAPHS, {
            "best_rounding": mac._best_rounding}
        names = ("pre", "pre_round", "post", "post_round")
    else:
        graphs, static = mac_mod.WOODBURY_FW_GRAPHS, mac._woodbury_static()
        names = ("setup", "gate", "finish")
    with graphs.solve("cuda", ops, **static) as loop:
        loop.run("init")
        if mac._dense:                   # the state the programs read
            loop.run("pre")
            mac_mod._dense_eigh(loop)
        else:
            loop.run("setup")
            loop.run_while("lobpcg", "lactive")
        for name in names:
            prof = _device_profile(lambda: loop.run(name), 5)
            out[name] = {k: prof.get(k)
                         for k in ("device_ms", "kernels_per_call")}
    return out


def phase_mac_calls(results, failures):
    """MAC's calls one by one on the card, measured as ROADMAP item 22
    asked before its MAC part: wall ms, device ms, CUDA kernels, copies to
    the host and host synchronizations per call (``torch.profiler``) of
    one ``torch.linalg.eigh`` of the padded, deflated Laplacian that the
    dense tier factors (P = 64 .. 512), one FW evaluation
    (``MAC.evaluate_objective``) on the dense tier (64 .. 512) and on the
    Woodbury tier (1024, 2048, 8192), each with its whole selection's
    time. Where the FW loop runs as step programs, also one LOBPCG stage
    as a while loop, as its body replayed and eagerly at (P, E) = (1024,
    1024), (1024, 4096), (8192, 1024) (:func:`_lobpcg_stage_times`, with
    its limits), where the host's time goes in one graphed selection at P
    = 512, 1024, 8192, and the device ms and kernels of one replay of each
    program there. Uses only what an older checkout's MAC has, so that the
    phase measures the checkout it is copied into."""
    import numpy as np
    import torch

    from cslam_tpu_torch.ops import fiedler as fd
    from cslam_tpu_torch.ops import highest_precision
    from cslam_tpu_torch.selection import mac as mac_mod
    rng = np.random.default_rng(0)
    out = results["mac_calls"] = {"eigh": [], "dense_eval": [],
                                  "woodbury_eval": []}

    def emit(kind, rec):
        out[kind].append(rec)
        print(f"  mac_calls {kind} " + json.dumps(rec))
    for P in (64, 128, 256, 512):
        mac = _call_mac(P, 1000, rng)
        w = torch.full((mac._E,), 0.3, device="cuda")
        L = mac._L_fixed + fd.laplacian_from_edges(mac._ci, mac._cj,
                                                   w * mac._cw, P)
        p = torch.clamp(torch.sum(mac._active), min=1.0)
        sigma = 2.0 * torch.max(torch.diagonal(L)) + 1.0
        u = mac._active / torch.sqrt(p)
        B = L + sigma * torch.diag(1.0 - mac._active) + sigma * torch.outer(
            u, u)
        B = 0.5 * (B + B.T)
        emit("eigh", {"P": P, **_call_record(lambda: torch.linalg.eigh(B))})
    for kind, tiers in (("dense_eval", (64, 128, 256, 512)),
                        ("woodbury_eval", (1024, 2048, 8192))):
        for P in tiers:
            mac = _call_mac(P, 1000, rng)
            w = np.full(mac._m, 0.3)
            rec = {"P": P, **_call_record(highest_precision(
                lambda: mac.evaluate_objective(w)), 5)}
            rec.update(_selection_ms(mac))
            emit(kind, rec)
    if not hasattr(mac_mod, "WOODBURY_FW_GRAPHS"):
        return                           # a checkout before the step programs
    out["stages"] = [_lobpcg_stage_times(_call_mac(P, E, rng), failures)
                     for P, E in ((1024, 1024), (1024, 4096), (8192, 1024))]
    out["host_split"], out["programs"] = [], []
    for P in (512, 1024, 8192):
        mac = _call_mac(P, 1000, rng)
        out["host_split"].append(_selection_host_split(mac))
        out["programs"].append(_program_profiles(mac))
    print("  mac_calls host_split " + json.dumps(out["host_split"]))
    print("  mac_calls programs " + json.dumps(out["programs"]))


def _scipy_lambda2(n, edges):
    """lambda_2 of the weighted graph on ``n`` nodes by scipy's shift-invert
    sparse eigensolver (as ``tests/test_fiedler.py`` computes it)."""
    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    i = [e.i for e in edges]
    j = [e.j for e in edges]
    w = [e.weight for e in edges]
    A = sp.coo_matrix((w + w, (i + j, j + i)), shape=(n, n)).tocsr()
    L = sp.diags(np.asarray(A.sum(1)).ravel()) - A
    vals = spla.eigsh(L.tocsc(), k=2, sigma=-1e-4, which="LM",
                      return_eigenvectors=False)
    return float(np.sort(vals)[1])


def _large_tiers_mac(failures, repeats=5):
    """``benchmarks/selection_bench.py``'s tiers through the port's ACM on
    the card: a warm selection (checked: size, lambda_2 against scipy, and
    at P = 2048 the same selection on the CPU), then ``repeats`` fresh
    builds and ``repeats`` steady rounds (20 new candidates before each).
    Returns the records and the last tier's MAC with its rounded
    selection."""
    import numpy as np
    import torch

    from cslam_tpu_torch.types import EdgeInterRobot
    rng = np.random.default_rng(0)
    out = []
    for R, Np, C in ((5, 100, 100), (10, 200, 400), (10, 500, 1000)):
        state = rng.bit_generator.state
        acm = _build_acm(R, Np, C, R, rng, "cuda")
        sel, seen = _recorded_selection(acm, R)
        _wait_prefetches()
        mac = seen["mac"]
        rec = {"robots": R, "poses": R * Np, "candidates": C,
               "P": mac._P, "E": mac._E,
               "tier": "dense" if mac._dense else "woodbury",
               "selected": len(sel), "fw_iters": acm.last_fw_iters}
        if not 0 < len(sel) <= 5 + R:
            failures.append(f"large_tiers MAC {R}x{Np}: {len(sel)} selected")
        chosen = [e for e, r in zip(seen["cands"], seen["rounded"]) if r]
        rec["lambda2"] = mac.evaluate_objective(seen["rounded"])
        rec["lambda2_scipy"] = _scipy_lambda2(mac.num_poses,
                                              seen["fixed"] + chosen)
        rel = abs(rec["lambda2"] / rec["lambda2_scipy"] - 1.0)
        rec["lambda2_rel_err"] = rel
        if not rel <= 0.02:
            failures.append(f"large_tiers MAC {R}x{Np}: lambda_2 "
                            f"{rec['lambda2']} vs scipy "
                            f"{rec['lambda2_scipy']}")
        rec["graphed_vs_eager"] = _mac_graphed_vs_eager(
            mac, seen, acm.max_iters, failures, f"large_tiers MAC {R}x{Np}")
        if mac._P == 2048:
            cpu_rng = np.random.default_rng()
            cpu_rng.bit_generator.state = state
            cpu_acm = _build_acm(R, Np, C, R, cpu_rng, "cpu")
            cpu_sel = cpu_acm.select_candidates(
                5, {r: True for r in range(R)})
            rec["same_as_cpu"] = ([e.key() for e in sel]
                                  == [e.key() for e in cpu_sel])
            if not rec["same_as_cpu"]:
                failures.append(f"large_tiers MAC {R}x{Np}: CUDA and CPU "
                                "selections differ")

        times = []
        _sync()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(repeats):
            acm2 = _build_acm(R, Np, C, R, rng, "cuda")
            with _Counters() as count:
                t0 = time.perf_counter()
                acm2.select_candidates(5, {r: True for r in range(R)})
                times.append(time.perf_counter() - t0)
        last = count.summary()     # the last fresh solve's counts
        rec["peak_device_mb"] = torch.cuda.max_memory_allocated() / 2**20
        steady = []
        for _ in range(repeats):
            for _k in range(20):
                r0 = int(rng.integers(0, R - 1))
                acm2.add_candidate_edge(EdgeInterRobot(
                    r0, int(rng.integers(0, Np)), r0 + 1,
                    int(rng.integers(0, Np)), float(rng.uniform(0.1, 1.0))))
            t0 = time.perf_counter()
            acm2.select_candidates(5, {r: True for r in range(R)})
            steady.append(time.perf_counter() - t0)
        rec.update(
            fresh_median_ms=float(np.median(times)) * 1e3,
            fresh_ms=[t * 1e3 for t in times],
            steady_median_ms=float(np.median(steady)) * 1e3,
            steady_fw_iters=acm2.last_fw_iters,
            lobpcg_iters_per_evaluation=(
                last["lobpcg_iters"] / last["evaluations"]
                if last["evaluations"] else None),
            evaluations_per_solve=last["evaluations"],
            host_reads_per_solve=last["host_reads"])
        print("  MAC " + json.dumps(rec))
        out.append(rec)
    return out, (mac, seen["rounded"])


def _g2o_graph(path):
    """A ``benchmarks/graphs`` init graph rebuilt as
    ``benchmarks/pgo_bench.py`` built it: same-robot edges plain,
    inter-robot edges robust (the last two are the injected outliers), one
    prior on (0, 0) at its init pose (the ground truth there). Returns
    (graph, arrays on the card)."""
    from cslam_tpu_torch.evaluation.g2o import read_g2o
    from cslam_tpu_torch.pgo import FactorGraph
    values, edges = read_g2o(path)
    g = FactorGraph()
    for key, pose in values.items():
        g.add_variable(key, pose)
    for e in edges:
        a, b = e.key_from.as_tuple(), e.key_to.as_tuple()
        g.add_between(a, b, e.measurement, e.noise_sigmas,
                      robust=a[0] != b[0])
    g.add_prior((0, 0), values[(0, 0)], edges[0].noise_sigmas)
    return g, g.to_arrays(device="cuda")


def _ate(est, gt):
    import numpy as np
    return float(np.sqrt(np.mean([np.sum((est[k][:3, 3] - gt[k][:3, 3]) ** 2)
                                  for k in gt])))


def _large_tiers_pgo(failures):
    """GNC cold (``gnc_optimize``) and warm (``gnc_reoptimize`` from the
    cold solution, translations scaled by 1 + 1e-6, carrying its weights)
    on ``benchmarks/graphs``' 8 x 256 and 8 x 512 graphs on the card, each
    solve's LM steps replayed from the tier's CUDA graphs: ``cold_first``
    is the tier's first solve (its captures included), ``cold`` the same
    solve again. On 8 x 256 the cold solve also runs twice eagerly (the
    same step programs launched one by one, ``eager=True``). Checked: both
    outliers rejected, ATE against ``*_gt.g2o`` within 0.05 m of the
    reference's ``*_optimized.g2o``; the PCG solves' host reads at most one
    per ``_CG_BLOCK`` CG iterations plus two per LM iteration; graphed
    against eager on 8 x 256 (:func:`_graphed_vs_eager`). Returns the
    records and the last graph's arrays with its cold weights."""
    import dataclasses

    import numpy as np
    import torch

    from cslam_tpu_torch.evaluation.g2o import read_g2o
    from cslam_tpu_torch.pgo import solver
    out = []
    for name in ("pgo_8x256", "pgo_8x512"):
        base = f"benchmarks/graphs/{name}"
        g, arrays = _g2o_graph(f"{base}_init.g2o")
        gt = read_g2o(f"{base}_gt.g2o")[0]
        ref_ate = _ate(read_g2o(f"{base}_optimized.g2o")[0], gt)
        robust = np.nonzero((arrays.robust * arrays.edge_valid).cpu().numpy()
                            > 0)[0]
        valid = arrays.node_valid.cpu().numpy() > 0
        rec = {"graph": name, "nodes": len(g), "padded_nodes":
               arrays.num_nodes, "genuine_loops": len(robust) - 2,
               "reference_optimized_ate_m": ref_ate,
               "init_ate_m": _ate({v.key.as_tuple(): v.pose for v in
                                   g.values_from_arrays(arrays.poses)}, gt)}
        runs, counts = {}, {}
        phases = ["cold_first", "cold", "warm"]
        if name == "pgo_8x256":
            phases += ["eager_1", "eager_2"]
        for phase in phases:
            with _Counters() as count:
                _sync()
                t0 = time.perf_counter()
                if phase == "warm":
                    poses = runs["cold"].poses.clone()
                    poses[:, :3, 3] *= 1.0 + 1e-6
                    res = solver.gnc_reoptimize(
                        dataclasses.replace(arrays, poses=poses),
                        runs["cold"].weights)
                else:
                    res = solver.gnc_optimize(
                        arrays, eager=phase.startswith("eager"))
                res.poses.cpu()
                seconds = time.perf_counter() - t0
            runs[phase], counts[phase] = res, count
            c = count.summary()
            w = res.weights.cpu().numpy()[robust]
            est = {v.key.as_tuple(): v.pose
                   for v in g.values_from_arrays(res.poses)}
            rec[phase] = {
                "seconds": seconds, "ate_m": _ate(est, gt),
                "outer_iterations": res.outer_iterations,
                "outliers_rejected": int((w[-2:] < 0.5).sum()),
                "loops_false_rejected": int((w[:-2] < 0.5).sum()),
                "lm_solves": c["lm_calls"],
                "cg_iters_per_lm_iteration": (c["cg_iters"] / c["lm_iters"]
                                              if c["lm_iters"] else None),
                **c, "graphs": count.graphs["by_program"]["lm_pcg"]}
            if rec[phase]["outliers_rejected"] != 2:
                failures.append(f"large_tiers {name} {phase}: "
                                f"{rec[phase]['outliers_rejected']} of 2 "
                                "outliers rejected")
            if not rec[phase]["ate_m"] <= ref_ate + 0.05:
                failures.append(f"large_tiers {name} {phase}: ATE "
                                f"{rec[phase]['ate_m']} > reference "
                                f"{ref_ate} + 0.05")
            excess = count.pcg_read_excess()
            if excess and not phase.startswith("eager"):
                failures.append(f"large_tiers {name} {phase}: PCG solves "
                                f"over their host-read bound {excess[:3]}")
            if phase == "cold" and count.graphs["captures"]:
                failures.append(f"large_tiers {name}: a second cold solve "
                                "captured again")
        rec["solver_pool_bytes"] = solver.PCG_GRAPHS.pool_bytes
        if "eager_1" in runs:
            rec["graphed_vs_eager"] = _graphed_vs_eager(
                f"large_tiers {name}", counts, runs, robust, valid, failures)
        print("  PGO " + json.dumps(rec))
        out.append(rec)
    return out, (arrays, runs["cold"].weights)


#: graphed GNC positions against eager at the end of the graduation, where
#: every LM decision was the same: with the sums in a fixed order
#: (``ops.segment_sum``) the graphed and both eager runs of 8 x 256 were
#: bit for bit in every run on the card, so they are held equal (the
#: atomic sums had put two eager runs up to 1.02e-2 m apart)
_GNC_GRADUATION_LIMIT_M = 0.0


def _graphed_vs_eager(tag, counts, runs, robust, valid, failures):
    """The graphed cold GNC (``runs["cold"]``) against the two eager ones
    (``counts``: each run's :class:`_Counters`): the same rejected robust
    edges and outer iterations; the same LM iterations in each solve whose
    stop test lies above float32's resolution of the cost (``rel_tol`` >=
    1e-5: every solve but the final polish, whose ``rel_tol`` 1e-7 is below
    it, so rounding picks its count and the eager runs differ there among
    themselves); positions at the end of the graduation (the last solve at
    ``rel_tol`` >= 1e-5, every decision so far the same in all three runs)
    within ``_GNC_GRADUATION_LIMIT_M`` of each eager run's. Reported beside
    it: the eager runs' own spread there (and max(10 x it, 1e-5 m)) and
    after the polish, and the graphed run's difference after the
    polish. The two eager runs must be bit for bit (positions at the end
    of the graduation and after the polish, and every LM count, the
    polish's included): their sums run in one fixed order."""
    import numpy as np
    eager = ("eager_1", "eager_2")
    modes = ("cold", *eager)

    def rejected(res):
        return set(robust[res.weights.cpu().numpy()[robust] < 0.5].tolist())

    def positions(poses):
        return poses.cpu().numpy()[valid][:, :3, 3]

    def diff(a, b):
        return float(np.abs(a - b).max())
    solves = {p: counts[p].lm_solves for p in modes}
    held = {p: [it for tol, it in v if tol >= 1e-5]
            for p, v in solves.items()}
    out = {"rejected_equal": len({frozenset(rejected(runs[p]))
                                  for p in modes}) == 1,
           "outer_iterations": [runs[p].outer_iterations for p in modes],
           "lm_iters_total": [sum(it for _, it in v)
                              for v in solves.values()],
           "lm_iters_below_resolution": [[it for tol, it in v if tol < 1e-5]
                                         for v in solves.values()],
           "lm_iters_held_equal": len({tuple(v) for v in
                                       held.values()}) == 1,
           "limit_m": _GNC_GRADUATION_LIMIT_M}
    if not out["rejected_equal"]:
        failures.append(f"{tag}: graphed and eager reject different edges")
    if len(set(out["outer_iterations"])) != 1:
        failures.append(f"{tag}: outer iterations graphed / eager "
                        f"{out['outer_iterations']}")
    if not out["lm_iters_held_equal"]:
        failures.append(f"{tag}: LM iterations per solve graphed / eager "
                        f"{solves}")
    if any(counts[p].held_poses is None for p in modes):
        failures.append(f"{tag}: no LM solve at rel_tol >= 1e-5 recorded, "
                        "graphed positions not compared with eager")
        return out
    at_end = {p: positions(counts[p].held_poses) for p in modes}
    final = {p: positions(runs[p].poses) for p in modes}
    out["eager_bit_for_bit"] = {
        "graduation": bool(np.array_equal(at_end["eager_1"],
                                          at_end["eager_2"])),
        "final": bool(np.array_equal(
            runs["eager_1"].poses.cpu().numpy(),
            runs["eager_2"].poses.cpu().numpy())),
        "lm_counts": solves["eager_1"] == solves["eager_2"]}
    if not all(out["eager_bit_for_bit"].values()):
        failures.append(f"{tag}: the two eager runs differ "
                        f"{out['eager_bit_for_bit']} (LM counts "
                        f"{solves['eager_1']} / {solves['eager_2']})")
    out.update(
        graduation_eager_spread_m=diff(at_end["eager_1"], at_end["eager_2"]),
        graduation_graphed_vs_eager_m={p: diff(at_end["cold"], at_end[p])
                                       for p in eager},
        graduation_ten_eager_spreads_m=max(10.0 * diff(
            at_end["eager_1"], at_end["eager_2"]), 1e-5),
        final_eager_spread_m=diff(final["eager_1"], final["eager_2"]),
        final_graphed_vs_eager_m={p: diff(final["cold"], final[p])
                                  for p in eager})
    worst = max(out["graduation_graphed_vs_eager_m"].values())
    if not worst <= _GNC_GRADUATION_LIMIT_M:
        failures.append(f"{tag}: graphed positions at the end of the "
                        f"graduation {out['graduation_graphed_vs_eager_m']} "
                        f"m from eager, limit {_GNC_GRADUATION_LIMIT_M}")
    return out


def _two_by_288(device, seed=7, n=288):
    """``tests/test_pgo.py``'s 2 x 288 construction (ground-truth init, low
    noise, a loop every 16 keyframes) as arrays on ``device``."""
    import numpy as np
    import torch

    from cslam_tpu_torch.ops import se3
    from cslam_tpu_torch.pgo import FactorGraph
    rng = np.random.default_rng(seed)
    sig = np.array([0.01] * 3 + [0.1] * 3)

    def circle(k, radius):
        a = 2 * np.pi * k / n
        T = np.eye(4)
        T[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                     [0, 0, 1]]
        T[:3, 3] = [radius * np.cos(a), radius * np.sin(a), 0.0]
        return T

    def noisy(Ta, Tb):
        xi = np.concatenate([rng.normal(scale=0.002, size=3),
                             rng.normal(scale=0.02, size=3)])
        return np.linalg.inv(Ta) @ Tb @ se3.exp(
            torch.as_tensor(xi, dtype=torch.float64)).numpy()

    g = FactorGraph()
    gt = {(r, k): circle(k, 10.0 + r) for r in (0, 1) for k in range(n)}
    for key, T in gt.items():
        g.add_variable(key, T)
    for r in (0, 1):
        for k in range(n - 1):
            g.add_between((r, k), (r, k + 1),
                          noisy(gt[(r, k)], gt[(r, k + 1)]), sig)
    for k in range(0, n, 16):
        g.add_between((0, k), (1, k), noisy(gt[(0, k)], gt[(1, k)]), sig,
                      robust=True)
    g.add_prior((0, 0), gt[(0, 0)], sig)
    return g.to_arrays(device=device)


def phase_large_tiers(results, failures):
    """MAC at ``benchmarks/selection_bench.py``'s three tiers (P = 512,
    2048, 8192) and GNC-TLS on ``benchmarks/graphs``' 8 x 256 and 8 x 512
    graphs, all on the card; LM on a 2 x 288 graph on the card against the
    same solve on the CPU."""
    import numpy as np
    import torch

    from cslam_tpu_torch.pgo import solver
    out = results["large_tiers"] = {}
    out["mac"], (mac, rounded) = _large_tiers_mac(failures)
    out["pgo"], (arrays_pgo, weights) = _large_tiers_pgo(failures)
    out["cg_block_sizes"] = _cg_block_sizes(arrays_pgo, weights)
    res = {}
    for device in ("cuda", "cpu"):
        arrays = _two_by_288(device)
        res[device] = solver.lm_optimize(arrays, torch.ones(
            arrays.num_edges, device=device), max_iters=15)
    err = float(np.abs(res["cuda"].poses.cpu().numpy()[:576]
                       - res["cpu"].poses.numpy()[:576]).max())
    out["lm_2x288_cuda_vs_cpu_max_abs_err"] = err
    print(f"  LM 2x288 (1024-node tier) CUDA vs CPU: max |pose diff| {err}")
    if not err <= 2e-3:
        failures.append(f"large_tiers LM 2x288: CUDA vs CPU {err} > 2e-3")

    out["small_linalg"] = _small_linalg_checks(mac, rounded, failures)

    # device-time breakdowns last: the profiler may slow what runs after it
    _wait_prefetches()
    out["mac_evaluation_profile"] = _device_profile(
        lambda: mac.evaluate_objective(rounded), 3)
    print(f"  one MAC evaluation at P = {mac._P} profile: "
          + json.dumps(out["mac_evaluation_profile"]))
    w_init = np.zeros(mac._m)
    out["mac_selection_profile"] = _device_profile(
        lambda: mac.fw_subset(w_init, 5, max_iters=20), 2)
    out["mac_selection_profile"]["loop"] = dict(mac.last_loop)
    print(f"  one graphed MAC selection at P = {mac._P} profile: "
          + json.dumps(out["mac_selection_profile"]))
    out["lm_step_profile"] = _device_profile(
        lambda: solver.lm_optimize(arrays_pgo, weights, max_iters=1), 3)
    print(f"  one LM step at {arrays_pgo.num_nodes} nodes profile: "
          + json.dumps(out["lm_step_profile"]))
    out["pcg_programs_profile"] = _pcg_programs_profile(arrays_pgo, weights)


_PCG_SOLVE = {"max_iters": 30, "rel_tol": 1e-5}   # gnc_optimize's first LM


def _cg_block_sizes(arrays, weights, sizes=(16, 8, 32, 16)):
    """The PCG tier's LM solve (``_PCG_SOLVE`` with the cold GNC weights,
    from the init poses) at CG block sizes K (``solver._CG_BLOCK``) 16, 8,
    32 and 16 again: wall seconds, host reads, LM and CG iterations, CG
    blocks replayed and the masked CG iterations they ran (blocks x K - CG
    iterations). Each K's first solve (its captures) runs untimed
    before."""
    import numpy as np
    import torch

    from cslam_tpu_torch.pgo import solver
    out, first = [], None
    saved = solver._CG_BLOCK
    try:
        for K in sizes:
            solver._CG_BLOCK = K
            solver.lm_optimize(arrays, weights, **_PCG_SOLVE).poses.cpu()
            with _Counters() as count:
                _sync()
                t0 = time.perf_counter()
                res = solver.lm_optimize(arrays, weights, **_PCG_SOLVE)
                res.poses.cpu()
                seconds = time.perf_counter() - t0
            blocks = count.graphs["by_program"]["lm_pcg"]["cg"]["replays"]
            first = res.poses.cpu().numpy() if first is None else first
            rec = {"K": K, "seconds": seconds,
                   "host_reads": count.host_reads,
                   "lm_iters": res.iterations, "cg_iters": res.cg_iterations,
                   "cg_blocks": blocks,
                   "masked_cg_iters": blocks * K - res.cg_iterations,
                   "captures": count.graphs["captures"],
                   "max_pose_diff_vs_first": float(np.abs(
                       res.poses.cpu().numpy() - first).max())}
            print("  CG block " + json.dumps(rec))
            out.append(rec)
    finally:
        solver._CG_BLOCK = saved
    return out


def _pcg_programs_profile(arrays, weights):
    """``torch.profiler`` of the PCG tier's programs at ``arrays``' tier
    (after every timing): a whole ``_PCG_SOLVE`` LM solve (graph launches,
    device time and idle share inside it), and one CG block replayed after
    that solve's stop (its K iterations masked, every kernel run: the
    kernels and device time of a block)."""
    from cslam_tpu_torch.pgo import solver
    out = {"K": solver._CG_BLOCK}
    out["solve"] = _device_profile(
        lambda: solver.lm_optimize(arrays, weights, **_PCG_SOLVE), 2)
    operands = solver._lm_operands(arrays, weights, _PCG_SOLVE["max_iters"],
                                   150, 1e-4, 1e-6, _PCG_SOLVE["rel_tol"])
    with solver.PCG_GRAPHS.solve(arrays.device, operands,
                                 coarse=solver._USE_COARSE,
                                 steps=solver._CG_BLOCK) as loop:
        solver._run_pcg(loop)
        out["cg_block"] = _device_profile(lambda: loop.run("cg"), 20)
    block = out["cg_block"]
    if block.get("device_ms"):
        out["device_ms_per_cg_iteration"] = block["device_ms"] / out["K"]
    print(f"  PCG programs at {arrays.num_nodes} nodes profile: "
          + json.dumps(out))
    return out


# -- phase distributed --------------------------------------------------------

# benchmarks/mesh_bank_bench.py's width: 131,072 x 64 rows per robot, k = 8,
# B = 256; 8 robot shards
_MESH_SHARDS, _MESH_ROWS, _MESH_DIM, _MESH_K, _MESH_B = 8, 131072, 64, 8, 256
#: the JAX package's own ``distributed_optimize`` on the 8 x 512 bench
#: graph with the same keywords (``tools/jax_distributed_g2o.py``, 8
#: virtual CPU devices): it misses ``large_tiers``' limit (the
#: ``_optimized.g2o`` file's ATE, 1.7529 m, + 0.05 m) at 30 sweeps with
#: ATE 2.6933 m and 27 genuine separators cut, so the port is held to that
#: ATE + 0.01 m and to no more genuine separators cut
_DIST_REFERENCE = {"ate_m": 2.693260041825973, "loops_false_rejected": 27}
_DIST_ATE_MARGIN = 0.01


def _dist_mesh_banks(failures):
    """``mesh_banks``: 8 robot shards at the bench width on a
    ``StackedMesh``, counts 131,072 down by 8,192 per shard, through
    ``MeshDescriptorBanks.search_all`` (the main path: one K1 launch per
    shard). Checked: each shard's top-8 bit for bit with K1's plain version
    on the card. Timed (CUDA events, warm): the search's device path (the
    8 K1 launches and the gather), the whole ``search_all`` (with the
    queries' upload and the results' download), one shard's K1, the plain
    versions, and ``matmul`` + ``topk`` over the stacked banks (the
    library yardstick)."""
    import numpy as np
    import torch

    from cslam_tpu_torch.matching.mesh_banks import MeshDescriptorBanks
    from cslam_tpu_torch.ops import nns
    from cslam_tpu_torch.utils.robot_mesh import StackedMesh
    rng = np.random.default_rng(11)
    banks = MeshDescriptorBanks(StackedMesh(_MESH_SHARDS, "cuda"),
                                _MESH_SHARDS, _MESH_DIM,
                                capacity=_MESH_ROWS, k=_MESH_K)
    counts = [_MESH_ROWS - 8192 * r for r in range(_MESH_SHARDS)]
    for rid, n in enumerate(counts):
        banks.add_items(rid, rng.standard_normal((n, _MESH_DIM),
                                                 dtype=np.float32),
                        list(range(n)))
    q_host = rng.standard_normal((_MESH_B, _MESH_DIM), dtype=np.float32)
    banks._sync()                       # the upload is set-up
    _sync()
    nns.launches = 0
    sims, idx = banks.search_all(q_host)             # the main path
    launches = nns.launches
    if launches != _MESH_SHARDS:
        failures.append(f"mesh_banks: {launches} K1 launches for "
                        f"{_MESH_SHARDS} shards")
    q = torch.from_numpy(q_host).cuda()
    dev = banks._banks
    errs = [_compare(f"mesh_banks shard {r} vs plain",
                     (torch.from_numpy(sims[r]).cuda(),
                      torch.from_numpy(idx[r]).cuda()),
                     nns.cosine_topk_scan_ref(dev[r], counts[r], q, _MESH_K),
                     failures)
            for r in range(_MESH_SHARDS)]
    rows = sum(counts)
    rec = {"shards": _MESH_SHARDS, "rows": rows, "B": _MESH_B, "k": _MESH_K,
           "launches": launches, "max_abs_err": max(errs),
           "ms": _time_ms(lambda: banks._search(dev, banks._device_counts,
                                                q), 20),
           "search_all_host_ms": _time_ms(lambda: banks.search_all(q_host),
                                          10),
           "one_shard_k1_ms": _time_ms(lambda: nns.cosine_topk_scan(
               dev[0], counts[0], q, _MESH_K), 20),
           "plain_ms": _time_ms(lambda: [nns.cosine_topk_scan_ref(
               dev[r], counts[r], q, _MESH_K) for r in range(_MESH_SHARDS)],
               2, warmup=1),
           "library_ms": _time_ms(lambda: torch.topk(torch.matmul(
               q, dev.transpose(1, 2)), _MESH_K, dim=-1), 10),
           **_bound(2.0 * _MESH_B * _MESH_DIM * rows,
                    4.0 * _MESH_DIM * (rows + _MESH_B)
                    + _MESH_SHARDS * _MESH_B * _MESH_K * 12.0, "float32")}
    print("  mesh_banks " + json.dumps(rec))
    return rec


#: host reads a graphed distributed solve may make: none before its
#: results, then ``distributed_optimize``'s reads of them (the poses, the
#: separator weights, sweeps, final delta, and the LM iterations with the
#: failed factorizations in one read)
_DIST_RESULT_READS = 5
#: graphed against the plain route (the same programs, driven from the
#: host): positions held as the GNC graduation's, equal
_DIST_POSE_LIMIT_M = _GNC_GRADUATION_LIMIT_M
#: the batched PCG tier against each robot's ``lm_optimize`` in turn, whose
#: CG dot products sum over other shapes: 10 x the largest difference
#: seen in three runs on the card (3.03e-4 m)
_DIST_IN_TURN_LIMIT_M = 3.1e-3


def _dist_graph_counts():
    from cslam_tpu_torch.pgo import distributed
    g = distributed.DIST_GRAPHS
    return g.captures, g.while_launches, len(g._loops)


def _dist_solve(tag, problem, mesh, gt, unslot, nb_sep, failures,
                route=None, warm=False, carried=None, graphed=True,
                **kwargs):
    """One ``distributed_optimize`` on the card, counted (``_Counters``):
    seconds, sweeps, LM iterations, host reads, WHILE-plan launches,
    captures and replays per program, ATE and the separators' sides of
    0.5. A graphed solve (the main path) fails the phase on a host read
    past ``_DIST_RESULT_READS`` and, unless it is its key's first, on a
    capture."""
    import numpy as np
    from cslam_tpu_torch.pgo.distributed import distributed_optimize
    before = _dist_graph_counts()
    segment_sum = _segment_sum_module()
    if segment_sum is not None:
        segment_sum.reset_launches()
    with _Counters() as count:
        _sync()
        t0 = time.perf_counter()
        est, info = distributed_optimize(
            problem, mesh, return_info=True, warm=warm,
            carried_weights=carried, _route=route, **kwargs)
        seconds = time.perf_counter() - t0
    after = _dist_graph_counts()
    w = info.sep_weights[:nb_sep]
    run = {"seconds": seconds, "route": route or "steps",
           "sweeps_used": info.sweeps_used,
           "lm_iters": info.lm_iterations, "host_reads": count.host_reads,
           "while_launches": after[1] - before[1],
           "first_of_key": after[2] > before[2],
           "graph_captures": count.graphs["captures"],
           "graph_replays": count.graphs["replays"],
           "by_program": {n: {p: c for p, c in progs.items()
                              if c["captures"] or c["replays"]}
                          for n, progs in count.graphs["by_program"].items()
                          if any(c["captures"] or c["replays"]
                                 for c in progs.values())},
           "segment_sum_launches": (None if segment_sum is None
                                    else segment_sum.device_launch_count()),
           "coarse_failures": getattr(info, "coarse_failures", None),
           "ate_m": _ate({(unslot[s], kf): p for (s, kf), p in est.items()},
                         gt),
           "outliers_rejected": int((w[-2:] < 0.5).sum()),
           "loops_false_rejected": int((w[:-2] < 0.5).sum())}
    if graphed:
        if run["host_reads"] > _DIST_RESULT_READS:
            failures.append(f"{tag}: {run['host_reads']} host reads, the "
                            f"graphed solve makes {_DIST_RESULT_READS}")
        if not run["first_of_key"] and run["graph_captures"]:
            failures.append(f"{tag}: {run['graph_captures']} captures in a "
                            "solve whose key was captured before")
        if run["while_launches"] != 1:
            failures.append(f"{tag}: {run['while_launches']} plan launches, "
                            "not 1")
        if run["segment_sum_launches"] == 0:
            failures.append(f"{tag}: no segment-sum kernel launch")
    print(f"  {tag} " + json.dumps(run))
    return run, est, info, np.asarray(info.sep_weights[:nb_sep])


def _dist_agree(tag, a, b, failures, limit=_DIST_POSE_LIMIT_M):
    """Graphed (``a``) against the plain route (``b``): the same sweeps,
    separators on the same side of 0.5, the same outliers rejected, and
    positions within ``limit``."""
    import numpy as np
    (ra, ea, _, wa), (rb, eb, _, wb) = a, b
    diff = max(float(np.abs(ea[k][:3, 3] - eb[k][:3, 3]).max()) for k in ea)
    out = {"sweeps": [ra["sweeps_used"], rb["sweeps_used"]],
           "weight_sides_differ": int(((wa < 0.5) != (wb < 0.5)).sum()),
           "max_weight_diff": float(np.abs(wa - wb).max()),
           "max_position_diff_m": diff,
           "seconds": [ra["seconds"], rb["seconds"]]}
    if ra["sweeps_used"] != rb["sweeps_used"]:
        failures.append(f"{tag}: {ra['sweeps_used']} sweeps graphed, "
                        f"{rb['sweeps_used']} on the plain route")
    if out["weight_sides_differ"]:
        failures.append(f"{tag}: {out['weight_sides_differ']} separators on "
                        "the other side of 0.5 on the plain route")
    if ra["outliers_rejected"] != rb["outliers_rejected"]:
        failures.append(f"{tag}: outliers rejected {ra['outliers_rejected']}"
                        f" graphed, {rb['outliers_rejected']} plain")
    out["limit_m"] = limit
    if not diff <= limit:
        failures.append(f"{tag}: positions {diff} m from the plain route's "
                        f"(limit {limit})")
    print(f"  {tag} " + json.dumps(out))
    return out


def _replay_ms(graph, n: int = 10) -> float:
    """CUDA-event ms per replay of a captured program, ``n`` replays back
    to back (nothing but the graph runs: its device time)."""
    import torch
    graph.replay()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(n):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _dist_program_ms(pcg: bool) -> dict:
    """Device ms per replay of the distributed programs of the newest key
    (``pre``, ``post``, the LM's programs) and of the plain route's
    batched LM step, replayed after the solves (every program computes
    in full whatever its flags say, so a replay past the stop costs what
    a live one does)."""
    from cslam_tpu_torch.pgo import distributed
    loop = list(distributed.DIST_GRAPHS._loops.values())[-1]
    names = (("pre", "lm_init", "head", "cg", "tail", "post") if pcg
             else ("pre", "lm_init", "lm_step", "post"))
    out = {n: _replay_ms(loop._captured[n]) for n in names}
    plain = distributed.BATCHED_PCG_GRAPHS if pcg \
        else distributed.BATCHED_GRAPHS
    if plain._loops:
        step = "cg" if pcg else "step"
        out[f"plain_{step}"] = _replay_ms(
            list(plain._loops.values())[-1]._captured[step])
    return out


def _dist_pgo(failures, central):
    """``pgo_8x512``: ``benchmarks/graphs/pgo_8x512_init.g2o`` split by robot
    as the back end splits it (``split_factor_graph``), then
    ``distributed_optimize`` on a ``StackedMesh`` of 8 with
    ``benchmarks/distributed_pgo_bench.py``'s keywords: cold (its key's
    first solve, which captures, then again), warm (from the cold
    solution, with its ``sep_weight_by_key``), each graphed (the main
    path: one plan launch) and on the plain route (host-driven sweeps,
    the same inputs). Checked against the JAX package's run of the same
    solve (``_DIST_REFERENCE``): both planted outliers below 0.5, no more
    genuine separators below 0.5, ATE against ``_gt.g2o`` within
    ``_DIST_ATE_MARGIN`` of its ATE; graphed against plain
    (:func:`_dist_agree`); host reads and captures (:func:`_dist_solve`).
    ``central`` is ``large_tiers``' record of the centralized GNC on the
    same graph, printed beside."""
    from cslam_tpu_torch.evaluation.g2o import read_g2o
    from cslam_tpu_torch.pgo.distributed import split_factor_graph
    from cslam_tpu_torch.tools.distributed_pgo_bench import set_poses
    from cslam_tpu_torch.utils.robot_mesh import StackedMesh
    base = "benchmarks/graphs/pgo_8x512"
    graph, _ = _g2o_graph(f"{base}_init.g2o")
    gt = read_g2o(f"{base}_gt.g2o")[0]
    ref_ate = _ate(read_g2o(f"{base}_optimized.g2o")[0], gt)
    problem, slot = split_factor_graph(graph, 0)
    unslot = {s: r for r, s in slot.items()}
    mesh = StackedMesh(problem.nb_robots, "cuda")
    nb_sep = len(problem.separators)
    rec = {"robots": problem.nb_robots, "poses": len(graph),
           "separators": nb_sep, "optimized_file_ate_m": ref_ate,
           "jax_distributed": _DIST_REFERENCE,
           "centralized_gnc": {p: (central or {}).get(p, {}).get("seconds")
                               for p in ("cold", "warm")}}
    kw = {"sweeps": 30, "lm_iters": 8, "cg_iters": 60}
    args = (problem, mesh, gt, unslot, nb_sep, failures)
    rec["cold_first"] = _dist_solve("pgo_8x512 cold_first", *args,
                                    **kw)[0]
    cold = _dist_solve("pgo_8x512 cold", *args, **kw)
    cold_plain = _dist_solve("pgo_8x512 cold_plain", *args, route="host",
                             graphed=False, **kw)
    set_poses(problem, cold[1])
    carried = cold[2].sep_weight_by_key
    warm = _dist_solve("pgo_8x512 warm", *args, warm=True, carried=carried,
                       **kw)
    warm_plain = _dist_solve("pgo_8x512 warm_plain", *args, warm=True,
                             carried=carried, route="host", graphed=False,
                             **kw)
    for phase, run in (("cold", cold[0]), ("warm", warm[0])):
        rec[phase] = run
        if run["outliers_rejected"] != 2:
            failures.append(f"pgo_8x512 {phase}: "
                            f"{run['outliers_rejected']} of 2 outliers "
                            "rejected")
        if (run["loops_false_rejected"]
                > _DIST_REFERENCE["loops_false_rejected"]):
            failures.append(f"pgo_8x512 {phase}: "
                            f"{run['loops_false_rejected']} genuine "
                            "separators rejected, the JAX package "
                            f"{_DIST_REFERENCE['loops_false_rejected']}")
        limit = _DIST_REFERENCE["ate_m"] + _DIST_ATE_MARGIN
        if not run["ate_m"] <= limit:
            failures.append(f"pgo_8x512 {phase}: ATE {run['ate_m']} > "
                            f"the JAX package's "
                            f"{_DIST_REFERENCE['ate_m']} + "
                            f"{_DIST_ATE_MARGIN}")
    rec["cold_plain"], rec["warm_plain"] = cold_plain[0], warm_plain[0]
    rec["cold_vs_plain"] = _dist_agree("pgo_8x512 cold vs plain", cold,
                                       cold_plain, failures)
    rec["warm_vs_plain"] = _dist_agree("pgo_8x512 warm vs plain", warm,
                                       warm_plain, failures)
    rec["program_ms"] = _dist_program_ms(False)
    # wall ms per sweep of the graphed cold solve: its init sweeps (2),
    # its sweeps and the polish
    rec["ms_per_sweep"] = (1e3 * cold[0]["seconds"]
                           / (cold[0]["sweeps_used"] + 3))
    print("  pgo_8x512 " + json.dumps(rec))
    return rec


def _dist_pcg(failures, robots=8, poses=1024):
    """``pgo_8x1024_pcg``: ``benchmarks/distributed_pgo_bench.py``'s world at
    8 robots x 1,024 poses (``--sep-every 16``, seed 0; built by its twin,
    ``tools/distributed_pgo_bench``), each robot's block on the PCG tier:
    ``distributed_optimize`` cold with the script's keywords, graphed
    (batched PCG programs in one plan launch; its key's first solve, then
    again) and on the plain route with each robot's ``lm_optimize`` in
    turn, with :func:`_dist_pgo`'s checks (both outliers rejected, graphed
    against plain), and the centralized GNC of the same graph beside."""
    import numpy as np
    from cslam_tpu_torch.pgo import gnc_optimize
    from cslam_tpu_torch.tools import distributed_pgo_bench as bench
    from cslam_tpu_torch.utils.robot_mesh import StackedMesh
    gt, problem, central, n_sep = bench.build(
        robots, poses, np.random.default_rng(0), 16)
    mesh = StackedMesh(robots, "cuda")
    nb_sep = len(problem.separators)
    unslot = {r: r for r in range(robots)}
    kw = {"sweeps": 30, **bench.KWARGS}
    args = (problem, mesh, gt, unslot, nb_sep, failures)
    rec = {"robots": robots, "poses": robots * poses, "separators": nb_sep,
           "ate_init_m": bench.ate({k: central.get_pose(k) for k in gt},
                                   gt)}
    rec["cold_first"] = _dist_solve("pgo_8x1024_pcg cold_first", *args,
                                    **kw)[0]
    graphed = _dist_solve("pgo_8x1024_pcg cold", *args, **kw)
    in_turn = _dist_solve("pgo_8x1024_pcg in_turn", *args, route="in_turn",
                          graphed=False, **kw)
    rec["cold"], rec["in_turn"] = graphed[0], in_turn[0]
    if graphed[0]["outliers_rejected"] != 2:
        failures.append(f"pgo_8x1024_pcg: {graphed[0]['outliers_rejected']}"
                        " of 2 outliers rejected")
    rec["cold_vs_in_turn"] = _dist_agree("pgo_8x1024_pcg cold vs in_turn",
                                         graphed, in_turn, failures,
                                         _DIST_IN_TURN_LIMIT_M)
    rec["program_ms"] = _dist_program_ms(True)
    arrays = central.to_arrays(device="cuda")
    with _Counters() as count:
        _sync()
        t0 = time.perf_counter()
        res = gnc_optimize(arrays)
        seconds = time.perf_counter() - t0
    est = {tuple(v.key.as_tuple()): v.pose
           for v in central.values_from_arrays(res.poses)}
    rec["centralized_gnc"] = {"seconds": seconds,
                              "outer_iterations": res.outer_iterations,
                              "ate_m": bench.ate(est, gt),
                              "graph_captures": count.graphs["captures"]}
    print("  pgo_8x1024_pcg " + json.dumps(rec))
    return rec


class _DistKeys:
    """Counts, while entered, each ``distributed._solve_steps`` call's
    captures and whether its key was new (``failures``: a capture in a
    solve whose key was captured before)."""

    def __init__(self, tag, failures):
        self.tag, self.failures, self.solves = tag, failures, []
        self.fails = []

    def __enter__(self):
        from cslam_tpu_torch.pgo import distributed
        self._orig = orig = distributed._solve_steps

        def counted(*args, **kwargs):
            before = _dist_graph_counts()
            out = orig(*args, **kwargs)
            after = _dist_graph_counts()
            new, caps = after[2] > before[2], after[0] - before[0]
            self.solves.append((new, caps))
            if len(out) > 5:        # the solve's failure counts (a device
                self.fails.append(out[5])   # tensor: read after the run)
            if caps and not new:
                self.failures.append(f"{self.tag}: {caps} captures in a "
                                     "solve whose key was captured before")
            return out
        distributed._solve_steps = counted
        return self

    def __exit__(self, *exc):
        from cslam_tpu_torch.pgo import distributed
        distributed._solve_steps = self._orig
        return False


def _dist_swarm(failures, robots=4, keyframes=60):
    """``swarm_distributed``: the simulated mission with
    ``backend.pgo_mode: distributed`` (``distributed_max_sweeps`` 12, as
    ``tests/test_runtime.py``'s swarm case) on the card. Checked: the
    distributed solve ran, every robot has estimates, every robot's ATE <=
    odometry + 0.05 m, at least 2 improve, K1 launched."""
    keys = _DistKeys("swarm_distributed", failures)
    before = _dist_graph_counts()
    wall, launches, spans, per_robot, count = _swarm_run(
        "swarm_distributed", failures, robots, keyframes,
        {"backend.pgo_mode": "distributed",
         "backend.distributed_max_sweeps": 12}, during=lambda: keys)
    after = _dist_graph_counts()
    solves = sum(r["distributed_solves"] for r in per_robot)
    if solves < 1:
        failures.append("swarm_distributed: no distributed solve")
    improved = 0
    for r in per_robot:
        if r["estimates"] <= 1:
            failures.append(f"swarm_distributed: robot {r['robot']} got "
                            "no estimates")
        if not r["ate_opt"] <= r["ate_odom"] + 0.05:
            failures.append(f"swarm_distributed: robot {r['robot']} ATE "
                            f"{r['ate_opt']} > odometry {r['ate_odom']} "
                            "+ 0.05")
        improved += r["ate_opt"] < r["ate_odom"]
    if improved < 2:
        failures.append(f"swarm_distributed: {improved} robots improved")
    if len(keys.solves) != solves:
        failures.append(f"swarm_distributed: {len(keys.solves)} solves "
                        f"through the step programs of {solves}")
    rec = {"distributed_solves": solves, "improved": improved,
           "keys": sum(new for new, _ in keys.solves),
           "captures_first_of_key": sum(c for new, c in keys.solves if new),
           "captures_after_first_of_key": sum(
               c for new, c in keys.solves if not new),
           "while_launches": after[1] - before[1],
           "coarse_failures": ([int(sum(f[0] for f in keys.fails)),
                                int(sum(f[1] for f in keys.fails))]
                               if keys.fails else None),
           "pgo_optimize_s": spans.get("pgo.optimize", {}).get("total_s")}
    print("  swarm_distributed " + json.dumps(rec))
    return {"wall_s": wall, "k1_launches": launches, **rec,
            **count.summary(), "graphs": count.graphs,
            "robots": per_robot}


def _dist_process_group(failures, ranks=4):
    """``process_group``: ``tools/dryrun_multichip`` with 4 rank processes
    on the one card over gloo (4 x 64 poses, 4 x 4,096-row banks), held
    against the ``StackedMesh`` run of the same problem here: poses within
    1e-4, the same sweeps, weights on the same side of 0.5, every rank
    exiting 0 with K1 launched and no ``jax`` / ``cslam_tpu`` module."""
    import numpy as np
    import torch

    from cslam_tpu_torch.tools import dryrun_multichip as dry
    from cslam_tpu_torch.utils.robot_mesh import StackedMesh
    sizes = {"poses": 64, "bank_rows": 4096, "capacity": 4096, "dim": 64,
             "k": 8}
    t0 = time.perf_counter()
    results = dry.run_ranks(ranks, "cuda", timeout=300, **sizes)
    wall = time.perf_counter() - t0
    stacked = dry.dryrun(StackedMesh(ranks, "cuda"), **sizes)
    _sync()
    failures.extend(f"process_group: {f}"
                    for f in dry.compare(results, stacked))
    for res in results:
        if res["k1_launches"] < 1:
            failures.append(f"process_group: rank {res['rank']} launched "
                            "no K1")
    rec = {"ranks": ranks, "wall_s": wall, "sweeps": stacked["sweeps"],
           "rank_seconds": [r["seconds"] for r in results],
           "stacked_seconds": stacked["seconds"],
           "k1_launches": sum(r["k1_launches"] for r in results),
           "bytes_gathered_per_sweep":
               results[0]["bytes_gathered_per_sweep"],
           "max_pose_diff_vs_stacked": max(
               float(np.abs(np.asarray(r["poses"][0])
                            - np.asarray(stacked["poses"][r["rank"]])).max())
               for r in results)}
    print("  process_group " + json.dumps(rec))
    return rec


def phase_distributed(results, failures):
    """The multi-device mode on the card: robot-sharded banks at the
    bench width, distributed PGO on the 8 x 512 bench graph, a swarm with
    ``backend.pgo_mode: distributed``, and 4 rank processes over gloo."""
    central = next((r for r in results.get("large_tiers", {}).get("pgo", [])
                    if r.get("graph") == "pgo_8x512"), None)
    out = results["distributed"] = {}
    before = _dist_graph_counts()
    for name, part in (("mesh_banks", _dist_mesh_banks),
                       ("pgo_8x512", lambda f: _dist_pgo(f, central)),
                       ("pgo_8x1024_pcg", _dist_pcg),
                       ("swarm_distributed", _dist_swarm),
                       ("process_group", _dist_process_group)):
        t0 = time.perf_counter()
        out[name] = part(failures)
        out[name]["part_s"] = time.perf_counter() - t0
        print(f"  {name}: {out[name]['part_s']:.1f} s")
    # the distributed solves' plan launches (each runs WHILE nodes)
    out["while_launches"] = _dist_graph_counts()[1] - before[1]


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


def _swarm_run(name, failures, robots, keyframes, overrides=None,
               during=None):
    """One simulated mission of ``robots`` x ``keyframes`` on the card (the
    main path), with ``overrides`` added to its config (and the context
    ``during()`` around the mission, after the warmups); checks robot 0's
    ATE and fixed inter-robot edges and the bank scan's launches. Returns
    (wall seconds, K1 launches, spans, per-robot records, the
    :class:`_Counters` of the mission, after the nodes' warmups)."""
    import torch

    from cslam_tpu_torch.ops import nns, small_linalg
    from cslam_tpu_torch.runtime.simulator import (SwarmSimulator,
                                                   SyntheticWorld,
                                                   circle_trajectory)
    from cslam_tpu_torch.selection import mac
    from cslam_tpu_torch.utils import profiling
    world = SyntheticWorld(nb_places=40, descriptor_dim=32, seed=0)
    trajs = [circle_trajectory(keyframes, radius=10.0 + 0.3 * r,
                               nb_places=40, start_angle=0.05 * r, z=0.2 * r)
             for r in range(robots)]
    config = {"frontend.inter_robot_detection_period_sec": 3.0,
              "frontend.inter_robot_loop_closure_budget": 5,
              "backend.pose_graph_optimization_start_period_ms": 2000,
              **(overrides or {})}
    sim = SwarmSimulator(robots, world, trajs, config_overrides=config,
                         keyframe_period=0.5, device="cuda")
    # MAC's selection programs, as a deployment warms them: every tier up
    # to twice the mission's poses (the tier prefetch looks one pose tier
    # ahead) and 4,096 candidates (the pool of a 4 x 120 swarm reaches the
    # 4,096 tier), at the mission's config
    t0 = time.perf_counter()
    mac.warmup_selection_tiers(2 * robots * keyframes, 4096, device="cuda",
                               **mac.mac_kwargs_from_params(config))
    _sync()
    print(f"  {name}: MAC selection warmup {time.perf_counter() - t0:.1f} s")
    profiling.reset_spans()
    nns.launches = 0
    small_linalg.reset_launches()
    segment_sum = _segment_sum_module()
    if segment_sum is not None:
        segment_sum.reset_launches()
    eigh = torch.linalg.eigh
    cuda_eigh = []

    def counted_eigh(A, *args, **kwargs):
        if A.is_cuda:
            cuda_eigh.append(tuple(A.shape))
        return eigh(A, *args, **kwargs)
    torch.linalg.eigh = counted_eigh
    try:
        with _Counters() as count, (during or contextlib.nullcontext)():
            t0 = time.perf_counter()
            sim.run(keyframes * 0.5 + 10.0, dt=0.25)   # the main path
            _sync()
            wall = time.perf_counter() - t0
    finally:
        torch.linalg.eigh = eigh
    launches = nns.launches
    count.small_linalg = small_linalg.device_launch_counts()
    count.segment_sum = (None if segment_sum is None
                         else segment_sum.device_launch_count())
    count.cuda_eigh_shapes = sorted(set(cuda_eigh))
    count.cuda_eigh_calls = len(cuda_eigh)
    print(profiling.report())
    spans = profiling.spans()
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
            "distributed_solves": robot.backend.distributed_solves,
            "estimates": len(robot.backend.current_pose_estimates),
            "ate_odom": odo, "ate_opt": opt})
    r0 = per_robot[0]
    print(f"  {name} {robots}x{keyframes}: {wall:.1f} s wall, "
          f"{launches} bank-scan launches")
    for rec in per_robot:
        print("  " + json.dumps(rec))
    if launches < 1:
        failures.append(f"{name}: bank-scan kernel not launched")
    if r0["fixed_edges"] < 1:
        failures.append(f"{name}: no fixed inter-robot edges")
    if not r0["ate_opt"] <= r0["ate_odom"] + 0.05:
        failures.append(f"{name}: optimized ATE {r0['ate_opt']} > odometry "
                        f"ATE {r0['ate_odom']} + 0.05")
    return wall, launches, spans, per_robot, count


def _pgo_record(tag, count, spans, failures):
    """The back end's PGO over a mission: ``pgo.optimize`` seconds, LM and
    CG iterations, host reads (all, and those of PCG-tier solves), the step
    programs' captures and replays, the graph pool's bytes (the solver
    sets' captures, all made by the warmup, and the device's shared pool).
    Limits: no capture after the warmup;
    each PCG solve within one host read per ``_CG_BLOCK`` CG iterations
    plus two per LM iteration."""
    from cslam_tpu_torch.utils import tier_graphs
    graphs = count.graphs
    rec = {"pgo_optimize_s": spans.get("pgo.optimize", {}).get("total_s"),
           **count.summary(), "graphs": graphs,
           "segment_sum_launches": getattr(count, "segment_sum", None),
           "solver_pool_bytes": {g.name: g.pool_bytes
                                 for g in _solver_graphs()},
           "shared_pool_bytes": tier_graphs.pool_bytes("cuda")}
    if graphs["captures"]:
        failures.append(f"{tag}: {graphs['captures']} solver graph captures "
                        f"after the warmup ({graphs['by_program']})")
    excess = count.pcg_read_excess()
    if excess:
        failures.append(f"{tag}: PCG solves over their host-read bound "
                        f"{excess[:3]}")
    if rec["lm_calls"] and rec["segment_sum_launches"] == 0:
        failures.append(f"{tag}: {rec['lm_calls']} LM solves and no "
                        "segment-sum kernel launch")
    print(f"  {tag} PGO " + json.dumps(rec))
    return rec


_MAC_SPANS = ("mac.fw_dispatch", "mac.fw_read", "lcd.select_dispatch",
              "mac.construct")


def _mac_record(tag, count, spans, failures, woodbury=False):
    """MAC over a mission: its spans (seconds and counts), the loop
    state's counters (selections, FW iterations, evaluations, LOBPCG
    calls, live and masked iterations, host reads), the selection
    programs' captures and replays, the small-eigensolver kernels' runs on
    the device, and the CUDA ``torch.linalg.eigh`` calls. Limits: each
    selection within its host-read bound (``_Counters.mac_read_excess``);
    on the Woodbury tier (``woodbury``) the kernels launched and no
    ``torch.linalg.eigh`` of a CUDA tensor."""
    summary = count.summary()
    by_program = count.graphs["by_program"]
    rec = {"spans": {k: spans.get(k) for k in _MAC_SPANS},
           **{k: summary[k] for k in (
               "mac_selections", "fw_iters", "evaluations", "lobpcg_calls",
               "lobpcg_iters", "lobpcg_masked", "mac_host_reads")},
           "host_reads_per_fw_iter": (summary["mac_host_reads"]
                                      / max(summary["fw_iters"], 1)),
           "programs": {k: by_program[k] for k in ("mac_dense",
                                                   "mac_woodbury")},
           "small_linalg_launches": count.small_linalg,
           "cuda_eigh_calls": count.cuda_eigh_calls,
           "cuda_eigh_shapes": count.cuda_eigh_shapes[:4]}
    excess = count.mac_read_excess()
    if excess:
        failures.append(f"{tag}: MAC selections over their host-read bound "
                        f"{excess[:3]}")
    if woodbury:
        if not count.small_linalg["eigh"] or not count.small_linalg["svd"]:
            failures.append(f"{tag}: the small-eigensolver kernels did not "
                            f"run ({count.small_linalg})")
        if count.cuda_eigh_calls:
            failures.append(f"{tag}: {count.cuda_eigh_calls} "
                            "torch.linalg.eigh calls on CUDA tensors "
                            f"{count.cuda_eigh_shapes[:4]}")
    print(f"  {tag} MAC " + json.dumps(rec))
    return rec


#: the back end's warmup in the swarm missions: every tier up to the
#: mission's 480 poses (``DecentralizedPGO.warmup``), as a deployment
#: warms the JAX package's solver
_SWARM_WARMUP = {"backend.warmup_poses": 480, "backend.warmup_edges": 1024}


def phase_swarm(results, failures, robots=4, keyframes=120):
    wall, launches, spans, per_robot, count = _swarm_run(
        "swarm", failures, robots, keyframes, _SWARM_WARMUP)
    pgo = _pgo_record("swarm", count, spans, failures)
    mac = _mac_record("swarm", count, spans, failures)

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
                        "spans": spans, "robots": per_robot, "pgo": pgo,
                        "mac": mac}


#: the JAX package's dtypes of a ``CSLAM_TPU_DUMP_PGO`` file's keys
_DUMP_INDEX_KEYS = ("edge_i", "edge_j", "prior_idx")


def _pgo_dump_replay(dump_dir, failures, tag="swarm_floored",
                     device="cuda"):
    """Part ``pgo_dumps``: the back end's ``CSLAM_TPU_DUMP_PGO`` files of a
    mission, each loaded with ``np.load(allow_pickle=False)`` (the keys of
    ``PoseGraphArrays``, int32 indices and float32 values, as the JAX
    package writes them), then the largest graph replayed through
    ``tools/pgo_replay`` on the card, graphed and eagerly. Limits: every
    file's keys and dtypes; graphed and eager GNC reject the same robust
    edges, their positions within ``_GNC_GRADUATION_LIMIT_M``; no capture
    in the graphed replay (the mission's warmup captured its tier)."""
    import numpy as np

    from cslam_tpu_torch.tools import harness, pgo_replay
    want = {k: "int32" if k in _DUMP_INDEX_KEYS else "float32"
            for k in pgo_replay.FIELDS}
    paths = sorted(Path(dump_dir).glob("*.npz"))
    out = {"dumps": len(paths), "files": [p.name for p in paths[:3]]}
    bad, sizes = [], []
    for path in paths:
        with np.load(path, allow_pickle=False) as z:
            got = {k: z[k].dtype.name for k in z.files}
            sizes.append((int(z["edge_valid"].sum()), path.name, path))
        if got != want:
            bad.append((path.name, got))
    out["bad_files"] = bad[:3]
    if not paths:
        failures.append(f"{tag}: no PGO dump written")
        return out
    if bad:
        failures.append(f"{tag}: dumps with other keys or dtypes {bad[:2]}")
    _, name, path = max(sizes)
    a = pgo_replay.load(path, device)
    before = harness.graph_counts()
    graphed, res_g = pgo_replay.replay(a, warm=1)
    graphs = harness.graph_delta(before)
    eager, res_e = pgo_replay.replay(a, eager=True, warm=0)
    valid = a.node_valid > 0
    dist = float((res_g.poses[valid, :3, 3] - res_e.poses[valid, :3, 3])
                 .norm(dim=-1).max())
    rej_g = pgo_replay.rejected_edges(a, res_g)
    rej_e = pgo_replay.rejected_edges(a, res_e)
    out.update({"replayed": name, **pgo_replay.graph_row(a),
                "graphed": graphed, "eager": eager,
                "rejected_graphed": rej_g[:8], "rejected_eager": rej_e[:8],
                "max_position_diff_m": dist,
                "limit_m": _GNC_GRADUATION_LIMIT_M,
                "replay_captures": graphs["captures"]})
    print(f"  pgo_dumps ({tag}) " + json.dumps(out, default=str))
    if rej_g != rej_e:
        failures.append(f"{tag}: graphed and eager replays of {name} reject "
                        f"{rej_g[:8]} and {rej_e[:8]}")
    if not dist <= _GNC_GRADUATION_LIMIT_M:
        failures.append(f"{tag}: graphed and eager replays of {name} "
                        f"{dist} m apart")
    if graphs["captures"]:
        failures.append(f"{tag}: {graphs['captures']} captures replaying "
                        f"{name} ({graphs['by_set']})")
    return out


def phase_swarm_floored(results, failures, robots=4, keyframes=120):
    """The swarm mission with the tiers pinned as deployments pin them
    (``frontend.mac_p_floor``, ``backend.pgo_np_floor`` and
    ``backend.pgo_ne_floor`` at 1024): every selection runs the
    Woodbury/LOBPCG MAC tier, every optimization the coarse-corrected PCG
    tier, on the card, its step programs captured by the back end's
    warmup; with ``CSLAM_TPU_DUMP_PGO`` set, then the dumps replayed
    (:func:`_pgo_dump_replay`)."""
    import tempfile

    from cslam_tpu_torch.pgo import solver
    from cslam_tpu_torch.selection import mac
    from cslam_tpu_torch.tools import harness
    with tempfile.TemporaryDirectory(prefix="cslam_pgo_dump_") as dumps:
        wall, launches, spans, per_robot, count = _swarm_run(
            "swarm_floored", failures, robots, keyframes,
            {"frontend.mac_p_floor": 1024, "backend.pgo_np_floor": 1024,
             "backend.pgo_ne_floor": 1024, **_SWARM_WARMUP},
            during=lambda: harness.dump_pgo(dumps))
        replay = _pgo_dump_replay(dumps, failures)
    tiers = sorted(mac._SEEN_TIERS)
    print(f"  MAC tiers seen {tiers}")
    pgo = _pgo_record("swarm_floored", count, spans, failures)
    mac_rec = _mac_record("swarm_floored", count, spans, failures,
                          woodbury=True)
    if not any(p == 1024 and mf > 0 for p, _, mf in tiers):
        failures.append("swarm_floored: no MAC solve on the Woodbury tier")
    if count.pcg_solves < 1:
        failures.append("swarm_floored: no PGO solve on the PCG tier")
    if not all(n > solver._DENSE_SOLVE_MAX_NODES for n in count.lm_nodes):
        failures.append("swarm_floored: a PGO solve on the dense tier")
    results["swarm_floored"] = {"launches": launches, "wall_s": wall,
                                "spans": spans, "robots": per_robot,
                                **pgo, "mac": mac_rec, "pgo_dumps": replay}


# -- phase mac_replay (not in the default run) -------------------------------

#: the trees ``mac_replay`` replays in (``--replay-roots``)
_REPLAY_ROOTS = ["."]


def _record_selections(failures) -> list:
    """The ``swarm_floored`` mission with every MAC selection's inputs
    recorded (the constructor's and ``fw_subset_dispatch``'s arguments);
    the warmups' and the tier prefetch threads' selections are not."""
    import threading

    import numpy as np

    from cslam_tpu_torch.selection import mac as mac_mod
    seen = []
    init, dispatch = mac_mod.MAC.__init__, mac_mod.MAC.fw_subset_dispatch

    def recorded_init(self, fixed, cands, nb_poses, *args, **kwargs):
        self._recorded = {"fixed": list(fixed), "cands": list(cands),
                          "nb_poses": nb_poses, "args": args,
                          "kwargs": {k: v for k, v in kwargs.items()
                                     if k != "device"}}
        init(self, fixed, cands, nb_poses, *args, **kwargs)

    def recorded_dispatch(self, w_init, k, *args, **kwargs):
        if not threading.current_thread().name.startswith("mac-prefetch"):
            seen.append(dict(self._recorded, w_init=np.array(w_init), k=k,
                             call_args=args,
                             call_kwargs={a: b for a, b in kwargs.items()
                                          if a != "eager"}))
        return dispatch(self, w_init, k, *args, **kwargs)

    @contextlib.contextmanager
    def recording():
        mac_mod.MAC.__init__ = recorded_init
        mac_mod.MAC.fw_subset_dispatch = recorded_dispatch
        try:
            yield
        finally:
            mac_mod.MAC.__init__ = init
            mac_mod.MAC.fw_subset_dispatch = dispatch
    _swarm_run("mac_replay", failures, 4, 120,
               {"frontend.mac_p_floor": 1024, "backend.pgo_np_floor": 1024,
                "backend.pgo_ne_floor": 1024, **_SWARM_WARMUP},
               during=recording)
    return seen


def _replay_worker(inputs: str, out: str, root: str) -> int:
    """One tree's replay (a process of its own): the recorded selections
    through ``root``'s ``cslam_tpu_torch``, graphed, after the tiers'
    warmup as the mission warms them; twice, the second pass timed by its
    ``mac.fw_dispatch`` span; then once eagerly (the same step programs
    launched one by one: other kernels, so other roundings). Writes per
    selection the selected candidates, FW iterations and loop counts of
    each pass."""
    import pickle

    import numpy as np
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from cslam_tpu_torch.ops import nns
    from cslam_tpu_torch.selection import mac as mac_mod
    from cslam_tpu_torch.utils import profiling
    nns.build()
    with open(inputs, "rb") as f:
        recs = pickle.load(f)
    config = {"frontend.mac_p_floor": 1024}
    mac_mod.warmup_selection_tiers(2 * 480, 4096, device="cuda",
                                   **mac_mod.mac_kwargs_from_params(config))
    torch.cuda.synchronize()
    passes = []
    for eager in (False, False, True):
        profiling.reset_spans()
        sel = []
        for rec in recs:
            m = mac_mod.MAC(rec["fixed"], rec["cands"], rec["nb_poses"],
                            *rec["args"], device="cuda", **rec["kwargs"])
            try:
                chosen = m.fw_subset(rec["w_init"], rec["k"],
                                     *rec["call_args"], eager=eager,
                                     **rec["call_kwargs"])[0]
                picked = np.flatnonzero(chosen > 0.5).tolist()
            except np.linalg.LinAlgError:
                picked = None
            sel.append({"selected": picked, "fw_iters": m.last_fw_iters,
                        "lobpcg_calls": int(m.last_loop.get(
                            "lobpcg_calls", -1))})
        torch.cuda.synchronize()
        span = profiling.spans().get("mac.fw_dispatch", {})
        passes.append({"eager": eager, "selections": sel,
                       "fw_dispatch_s": span.get("total_s")})
    Path(out).write_text(json.dumps({
        "root": str(Path(root).resolve()),
        "module": mac_mod.__file__, "passes": passes}))
    return 0


def _lambda2(rec, selected):
    """lambda_2 of the fixed edges plus the selected candidates, float64."""
    import numpy as np
    if selected is None:
        return None
    n = rec["nb_poses"]
    L = np.zeros((n, n))
    for e in rec["fixed"] + [rec["cands"][i] for i in selected]:
        L[e.i, e.i] += e.weight
        L[e.j, e.j] += e.weight
        L[e.i, e.j] -= e.weight
        L[e.j, e.i] -= e.weight
    return float(np.linalg.eigvalsh(L)[1])


def _compare_selections(recs, a, b) -> dict:
    """Two replays of the same selections: how many pick the same edges and
    take the same FW iterations, and the exact lambda_2 of each."""
    rows = []
    for rec, sa, sb in zip(recs, a, b):
        la = _lambda2(rec, sa["selected"])
        lb = _lambda2(rec, sb["selected"])
        rows.append({
            "same": sa["selected"] == sb["selected"],
            "fw_iters": [sa["fw_iters"], sb["fw_iters"]],
            "lobpcg_calls": [sa["lobpcg_calls"], sb["lobpcg_calls"]],
            "lambda2": [la, lb],
            "rel_diff": (None if la is None or lb is None else
                         abs(la - lb) / max(la, lb, 1e-30))})
    return {"same": sum(r["same"] for r in rows),
            "same_fw_iters": sum(r["fw_iters"][0] == r["fw_iters"][1]
                                 for r in rows),
            "max_rel_diff_lambda2": max(
                [r["rel_diff"] for r in rows if r["rel_diff"] is not None],
                default=None),
            "per_selection": rows}


def phase_mac_replay(results, failures):
    """Record ``swarm_floored``'s selections, replay them in each tree of
    ``--replay-roots`` (a, b, b, a) and compare them (see the module's
    docstring)."""
    import pickle
    import tempfile
    recs = _record_selections(failures)
    roots = list(dict.fromkeys(_REPLAY_ROOTS))
    order = roots + roots[::-1]
    runs = []
    with tempfile.TemporaryDirectory(prefix="cslam_replay_") as tmp:
        inputs = str(Path(tmp) / "inputs.pkl")
        with open(inputs, "wb") as f:
            pickle.dump(recs, f)
        for n, root in enumerate(order):
            out = str(Path(tmp) / f"{n}.json")
            proc = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()),
                 "--replay-worker", inputs, out, "--replay-roots", root],
                capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                failures.append(f"mac_replay: the replay in {root} failed: "
                                f"{proc.stderr[-2000:]}")
                return
            runs.append(json.loads(Path(out).read_text()))
    by_root = {}
    for root, run in zip(order, runs):
        by_root.setdefault(root, []).extend(run["passes"])
    out = results["mac_replay"] = {"selections": len(recs), "trees": {}}
    for root, passes in by_root.items():
        graphed = [p for p in passes if not p["eager"]]
        eager = [p for p in passes if p["eager"]]
        differ = sum(any(p["selections"][i]["selected"]
                         != graphed[0]["selections"][i]["selected"]
                         for p in graphed) for i in range(len(recs)))
        eager_vs_graphed = _compare_selections(
            recs, graphed[0]["selections"], eager[0]["selections"])
        out["trees"][root] = {
            "module": next(r["module"] for o, r in zip(order, runs)
                           if o == root),
            "fw_dispatch_s_timed_passes": [p["fw_dispatch_s"]
                                           for p in graphed[1::2]],
            "fw_dispatch_s_eager": [p["fw_dispatch_s"] for p in eager],
            "fw_iters": sum(s["fw_iters"] for s in
                            graphed[1]["selections"]),
            "lobpcg_calls": sum(s["lobpcg_calls"] for s in
                                graphed[1]["selections"]),
            "selections_differing_between_its_runs": differ,
            "eager_vs_graphed": eager_vs_graphed}
        if differ:
            failures.append(f"mac_replay: {differ} selections differ "
                            f"between {root}'s own graphed runs")
    if len(roots) > 1:
        a, b = (by_root[r][0]["selections"] for r in roots[:2])
        out["pair"] = roots[:2]
        out.update(_compare_selections(recs, a, b))
    print("  mac_replay " + json.dumps(out))


def _cyclic_svd_sweeps(a, max_sweeps=40) -> int:
    """The sweeps that a cyclic one-sided Jacobi SVD (n(n - 1)/2 rotations
    in a row per sweep, with the round-robin kernel's skip test and stop
    rule) runs on the block ``a``, its last, rotation-free one included: a
    float64 numpy diagnostic beside an older checkout's cyclic kernel (its
    sums are not that kernel's shuffle trees)."""
    import numpy as np
    x = np.array(a, dtype=np.float64)
    n = x.shape[0]
    for sweep in range(1, max_sweeps + 1):
        rotated = False
        for p in range(n - 1):
            for q in range(p + 1, n):
                alpha, beta = x[:, p] @ x[:, p], x[:, q] @ x[:, q]
                gamma = x[:, p] @ x[:, q]
                if (abs(gamma) <= 1e-15 * n * np.sqrt(alpha * beta)
                        or gamma == 0.0):
                    continue
                rotated = True
                theta = (beta - alpha) / (2.0 * gamma)
                t = (0.5 / theta if abs(theta) > 1e150 else
                     np.sign(theta or 1.0)
                     / (abs(theta) + np.sqrt(theta * theta + 1.0)))
                c = 1.0 / np.sqrt(t * t + 1.0)
                xp, xq = x[:, p].copy(), x[:, q]
                x[:, p] = c * xp - t * c * xq
                x[:, q] = t * c * xp + c * xq
        if not rotated:
            return sweep
    return max_sweeps


def _svd_ab_worker(inputs: str, out: str, root: str) -> int:
    """One tree's SVD kernel (a process of its own, ``root``'s
    ``cslam_tpu_torch``): every case of ``inputs`` one call at a time, as
    LOBPCG calls it; then, after a second of large products (so that the
    card is off its idle clocks), CUDA-event ms per eager call (200 calls),
    device ms per call (``torch.profiler``, 50 calls) and ms per call
    replayed back to back from a CUDA graph (:func:`_graph_call_ms`, with
    the SM clock read after it) at 4 x 4 (a recorded block) and 12 x 12,
    batch 1, and at batch 1,024 (the recorded blocks in turn); and the
    graph-replayed ms of each recorded block. Saves the outputs and the
    times."""
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from cslam_tpu_torch.ops import nns
    from cslam_tpu_torch.ops import small_linalg as sl
    nns.build(["small_eigh"])
    cases = torch.load(inputs)
    outputs = {name: [[x.cpu() for x in sl.svd(A.cuda())] for A in mats]
               for name, mats in cases["groups"].items()}
    # a second of large products first: the card leaves its idle clocks
    big = torch.ones((4096, 4096), device="cuda")
    t_end = time.perf_counter() + 1.0
    while time.perf_counter() < t_end:
        big @ big
        _sync()
    times = {}
    for label, A in (("4x4", cases["block4"]), ("12x12", cases["block12"]),
                     ("4x4_batch1024", cases["batch1024"])):
        A = A.cuda()
        if A.dim() == 2:
            times[f"{label}_event_ms"] = _time_ms(lambda: sl.svd(A), 200)
        times[f"{label}_device_ms"] = _device_profile(
            lambda: sl.svd(A), 50 if A.dim() == 2 else 20).get("device_ms")
        times[f"{label}_graph_ms"] = _graph_call_ms(lambda: sl.svd(A))
        times[f"{label}_sm_clock_mhz"] = _sm_clock_mhz()
    per_block = [_graph_call_ms(lambda: sl.svd(A), 50, 5)
                 for A in (B.cuda() for B in cases["groups"]["selection"])]
    torch.save({"root": str(Path(root).resolve()), "module": sl.__file__,
                "outputs": outputs, "times": times,
                "graph_ms_per_block": per_block}, out)
    return 0


def phase_small_svd_ab(results, failures):
    """The SVD kernel of each tree of ``--replay-roots`` on the same inputs,
    a, b, b, a in fresh processes (:func:`_svd_ab_worker`): the 4 x 4
    blocks of one eager Woodbury selection at P = 1024 (and
    :func:`_svd_cases`' seeded and rank-deficient blocks), with the times
    per tree, the sweeps per recorded block (this checkout's mirror where
    it has one; the cyclic order's, :func:`_cyclic_svd_sweeps`), and which
    outputs differ between the trees. A tree whose two runs differ fails
    the phase."""
    import tempfile

    import numpy as np
    import torch

    from cslam_tpu_torch.ops import small_linalg as sl
    rng = np.random.default_rng(13)
    groups = {name: [A.cpu() for A in mats] for name, mats in _svd_cases(
        _call_mac(1024, 1024, rng), rng).items()}
    recorded = groups["selection"]
    if not recorded:
        failures.append("small_svd_ab: the selection decomposed no block")
        return
    inputs = {"groups": groups, "block4": recorded[0],
              "block12": next(A for A in groups["random"]
                              if A.shape[-1] == 12),
              "batch1024": torch.stack([recorded[i % len(recorded)]
                                        for i in range(1024)])}
    roots = list(dict.fromkeys(_REPLAY_ROOTS))
    order = roots + roots[::-1]
    runs = []
    with tempfile.TemporaryDirectory(prefix="cslam_svd_ab_") as tmp:
        path = str(Path(tmp) / "inputs.pt")
        torch.save(inputs, path)
        for n, root in enumerate(order):
            res = str(Path(tmp) / f"{n}.pt")
            proc = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()),
                 "--svd-ab-worker", path, res, "--replay-roots", root],
                capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                failures.append(f"small_svd_ab: the run in {root} failed: "
                                f"{proc.stderr[-2000:]}")
                return
            runs.append(torch.load(res))

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    out = results["small_svd_ab"] = {"blocks": len(recorded), "trees": {}}
    sweeps = {"cyclic": [_cyclic_svd_sweeps(A.numpy()) for A in recorded]}
    if hasattr(sl, "svd_jacobi_ref"):
        sweeps["round_robin"] = sl.svd_jacobi_ref(
            torch.stack(recorded), return_sweeps=True)[3].tolist()
    out["sweeps_per_recorded_block"] = {
        k: {"min": min(v), "max": max(v), "mean": sum(v) / len(v)}
        for k, v in sweeps.items()}
    by_root = {}
    for root, run in zip(order, runs):
        by_root.setdefault(root, []).append(run)
    for root, (first, second) in by_root.items():
        differ = sum(not same(a, b) for name in groups for a, b in zip(
            first["outputs"][name], second["outputs"][name]))
        blocks = first["graph_ms_per_block"] + second["graph_ms_per_block"]
        out["trees"][root] = {
            "module": first["module"],
            "times": {k: [first["times"][k], second["times"][k]]
                      for k in first["times"]},
            "graph_ms_per_recorded_block": {
                "min": min(blocks), "max": max(blocks),
                "mean": sum(blocks) / len(blocks)},
            "outputs_differing_between_its_runs": differ}
        if differ:
            failures.append(f"small_svd_ab: {differ} outputs differ "
                            f"between {root}'s own runs")
    if len(roots) > 1:
        a, b = (by_root[r][0]["outputs"] for r in roots[:2])
        cross = {}
        for name in groups:
            pairs = list(zip(a[name], b[name]))
            cross[name] = {
                "same": sum(same(x, y) for x, y in pairs),
                "of": len(pairs),
                "max_abs_s_diff": max(float((x[1] - y[1]).abs().max())
                                      for x, y in pairs),
                "max_abs_polar_diff": max(
                    float((x[0] @ x[2] - y[0] @ y[2]).abs().max())
                    for x, y in pairs)}
        out["pair"], out["cross_tree"] = roots[:2], cross
    print("  small_svd_ab " + json.dumps(out))


# -- phase lidar ------------------------------------------------------------

_SC_SHAPE = (20, 60)
_ROT_TOL_DEG, _TRANS_TOL_M = 1.0, 0.1     # verify: against ground truth


def _scene_cloud(seed, n):
    """``benchmarks/lidar_e2e_scale_bench.py``'s structured scene: two
    walls, ground scatter and five pillars (the pillars pin the ICP), as
    ``tools/lidar_e2e_scale.scene_cloud`` draws it."""
    from cslam_tpu_torch.tools.lidar_e2e_scale import scene_cloud
    return scene_cloud(seed, n)


def _pose_at(x, y, yaw=0.0):
    from cslam_tpu_torch.tools.harness import pose_xyz_yaw
    return pose_xyz_yaw(x, y, 0.0, yaw)


def _observe(scene, pose, rng):
    """Scene points (world frame) in the frame of a sensor at ``pose``,
    with 3 cm noise."""
    import numpy as np
    inv = np.linalg.inv(pose)
    pts = scene @ inv[:3, :3].T + inv[:3, 3]
    return (pts + rng.normal(scale=0.03, size=pts.shape)).astype(np.float32)


def _sparse_scans(rng, shape):
    """``benchmarks/scancontext_scale_bench.py``'s scans: 30% of the cells
    set, heights up to 8 m."""
    import numpy as np
    return ((rng.random(shape, dtype=np.float32)
             * (rng.random(shape, dtype=np.float32) > 0.7))
            * np.float32(8.0))


def _lidar_search(failures, device="cuda", N=65536, chunks=8, B=16):
    """Part ``sc_search``: a seeded bank of N scans searched in B-query
    chunks (half revisits of bank rows, rotated and perturbed; half new
    scans) and at B = 1, unfused (stage 1 = ``euclidean_topk``) and fused
    (stage 1 = K1 on the augmented ring keys), through
    ``ScanContextBank``; the best rows must agree, and K1 must agree bit for
    bit with its plain version on the augmented bank at B = B and 1."""
    import numpy as np
    import torch

    from cslam_tpu_torch.matching import scancontext_bank as scb
    from cslam_tpu_torch.ops import nns
    rng = np.random.default_rng(0)
    scans = _sparse_scans(rng, (N,) + _SC_SHAPE)
    banks = {}
    for name, fused in (("unfused", False), ("fused", True)):
        bank = scb.ScanContextBank(capacity=N, fused_stage1=fused,
                                   device=device)
        for i in range(N):
            bank.add_item(scans[i], i)
        bank._sync_device()
        banks[name] = bank
    if not banks["fused"]._fused_stage1_ok():
        failures.append("lidar sc_search: the fused bank fails its gate")
    src = rng.integers(0, N, (chunks, B // 2))
    shift = rng.integers(0, _SC_SHAPE[1], (chunks, B // 2))
    queries = _sparse_scans(rng, (chunks, B) + _SC_SHAPE)
    for c in range(chunks):
        for j in range(B // 2):
            queries[c, j] = np.roll(scans[src[c, j]], shift[c, j], axis=1) \
                + rng.normal(0, 0.02, _SC_SHAPE).astype(np.float32)
    _sync()
    best = {}
    launches = {}
    for name, bank in banks.items():
        nns.launches = 0
        t0 = time.perf_counter()
        found = [bank.search_best_batch(q.reshape(B, -1)) for q in queries]
        one = [bank.search_best(q.reshape(-1)) for q in queries[:, 0]]
        _sync()
        wall = time.perf_counter() - t0
        launches[name] = nns.launches       # the main path's K1 launches
        best[name] = ([[item for item, _ in f] for f in found],
                      [item for item, _ in one])
        print(f"  sc_search {name}: {chunks} chunks of {B} + {chunks} single"
              f" queries against {N} scans in {wall * 1e3:.1f} ms, "
              f"{launches[name]} K1 launch(es)")
    out = {"bank_rows": N, "chunk": B, "launches": launches}
    out["best_rows_equal"] = best["fused"] == best["unfused"]
    revisits = [row[:B // 2] for row in best["fused"][0]]
    out["revisits_found"] = float(np.mean(np.asarray(revisits) == src))
    if not out["best_rows_equal"]:
        failures.append("lidar sc_search: fused and unfused best rows differ")
    if launches["fused"] < 1 or launches["unfused"] != 0:
        failures.append(f"lidar sc_search: K1 launches {launches}")
    if out["revisits_found"] < 1.0:
        failures.append(f"lidar sc_search: revisits found "
                        f"{out['revisits_found']}")

    fused, plain = banks["fused"], banks["unfused"]
    aug = fused._rk_aug
    for b in (B, 1):
        q_sc = torch.from_numpy(queries[0, :b]).to(device)
        rk_q = q_sc.mean(-1)
        q_aug = scb._augment_queries(rk_q)
        rec, _ = _scan_case("bank_scan", f"lidar augmented ring keys B={b}",
                            aug, None, N, q_aug, fused.num_candidates,
                            failures)
        out[f"k1_b{b}"] = rec

        def run_fused():
            return scb._two_stage_best_fused(aug, fused._sc_bank, N, q_sc,
                                             10)

        def run_unfused():
            return scb._two_stage_best(plain._rk_bank, plain._rk_sq_norms,
                                       plain._sc_bank, N, q_sc, 10)

        def k1():
            return nns.cosine_topk_scan(aug, N, q_aug, 10)

        def library():
            return torch.topk(q_aug @ aug.T, 10, dim=1)

        def euclid():
            return scb.topk_ops.euclidean_topk(plain._rk_bank,
                                               plain._rk_sq_norms, N, rk_q,
                                               10)
        ms_f, ms_u = _time_ms(run_fused, 20), _time_ms(run_unfused, 20)
        out[f"b{b}"] = {
            "fused_ms_per_chunk": ms_f, "unfused_ms_per_chunk": ms_u,
            "fused_queries_per_s": b / ms_f * 1e3,
            "unfused_queries_per_s": b / ms_u * 1e3,
            "k1_ms": _time_ms(k1, 20),
            "k1_plain_ms": _time_ms(
                lambda: nns.cosine_topk_scan_ref(aug, N, q_aug, 10), 3, 1),
            "k1_library_ms": _time_ms(library, 20),
            "euclidean_topk_ms": _time_ms(euclid, 20),
            # augmented rows and queries in, f32 + int64 out; the dots
            **_bound(2.0 * b * N * 32, N * 32 * 4 + b * 32 * 4 + b * 10 * 12,
                     "float32")}
        print(f"  sc_search B={b}: " + json.dumps(out[f"b{b}"]))
    for name in ("fused", "unfused"):
        out[f"{name}_b{B}_profile"] = _device_profile(
            lambda bank=banks[name]: bank.search_best_batch(
                queries[0].reshape(B, -1)), 10)
        print(f"  sc_search {name} B={B} profile: "
              + json.dumps(out[f"{name}_b{B}_profile"]))
    del banks
    torch.cuda.empty_cache()
    return out


def _verify_pairs(rng):
    """8 pairs at the lidar mission's width (4096-point scenes, voxel
    0.4 m): 4 revisits of a scene from a second pose with a known yaw and
    offset, then 4 pairs of two different scenes. Returns (pairs, the 4
    ground-truth Z = X_src^-1 X_dst)."""
    import numpy as np

    from cslam_tpu_torch.ops.registration import voxel_downsample
    scenes = [_scene_cloud(1000 + s, 4096) for s in range(8)]
    pairs, truth = [], []
    for j, (x, y, yaw) in enumerate(((0.8, 0.6, 0.4), (2.0, -1.0, 1.2),
                                     (-1.5, 2.0, 2.5), (3.0, 1.0, -2.0))):
        B = _pose_at(x, y, yaw)
        pairs.append((voxel_downsample(_observe(scenes[j], np.eye(4), rng),
                                       0.4),
                      voxel_downsample(_observe(scenes[j], B, rng), 0.4)))
        truth.append(B)
    for j in range(4):
        other = scenes[4 + (j + 1) % 4]
        pairs.append((voxel_downsample(_observe(scenes[4 + j], np.eye(4),
                                                rng), 0.4),
                      voxel_downsample(_observe(other, _pose_at(1.0, 0.5,
                                                                0.7), rng),
                                       0.4)))
    return pairs, truth


def _syncs_in(fn):
    """Synchronizing CUDA calls ``torch.cuda.set_sync_debug_mode`` reports
    while ``fn`` runs, and where."""
    import warnings

    import torch
    _sync()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return [f"{w.filename}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message)]


def _graph_vs_eager(tag, graphs, operands, failures, repeats=5, **static):
    """One chunk through ``graphs`` (a ``utils.tier_graphs.TierGraphs``:
    the CUDA graph of this key, captured at its first call) and through
    its eager function on the same device operands. Limits: every output
    but T equal (inliers and flags), T's largest absolute difference
    printed (expected 0); no host sync inside a graphed chunk. Then each
    path's time per chunk (CUDA events, warm) and the graph pool's bytes.
    Returns (record, graphed call, eager call) for the profiles, which run
    last."""
    import torch

    from cslam_tpu_torch.utils import tier_graphs
    device = operands[0].device

    def graph():
        return graphs(device, *operands, **static)

    def eager():
        return graphs.fn(*operands, **static)
    got, want = graph(), eager()
    _sync()
    rec = {"max_abs_T_diff_eager": float((got[0] - want[0]).abs().max()),
           "outputs_equal_eager": [bool(torch.equal(a, b))
                                   for a, b in zip(got[1:], want[1:])]}
    if not all(rec["outputs_equal_eager"]):
        failures.append(f"{tag}: graphed outputs differ from eager "
                        f"{rec['outputs_equal_eager']}")
    for name, fn in (("graph", graph), ("eager", eager)):
        rec[f"{name}_ms_per_chunk"] = _time_ms(fn, repeats, 1)
    # what switching the mode reports itself is not the chunk's
    empty = _syncs_in(lambda: None)
    for name, fn in (("graph", graph), ("eager", eager)):
        rec[f"{name}_host_syncs"] = [w for w in _syncs_in(fn)
                                     if w not in empty]
    if rec["graph_host_syncs"]:
        failures.append(f"{tag}: host syncs in a graphed chunk "
                        f"{rec['graph_host_syncs']}")
    _sync()
    torch.cuda.reset_peak_memory_stats()
    eager()
    _sync()
    rec["eager_peak_device_mb"] = torch.cuda.max_memory_allocated() / 2 ** 20
    rec.update(captures=graphs.captures, replays=graphs.replays,
               graph_pool_bytes=graphs.pool_bytes,
               shared_pool_bytes=tier_graphs.pool_bytes(device))
    return rec, graph, eager


def _graph_profiles(tag, rec, graph, eager, failures, iters=5):
    """``torch.profiler`` of a graphed and an eager chunk (after every
    timing); a graphed chunk must be one ``cudaGraphLaunch``."""
    rec["graph_profile"] = _device_profile(graph, iters)
    rec["eager_profile"] = _device_profile(eager, 3)
    launched = rec["graph_profile"]["graph_launches_per_call"]
    if launched != 1:
        failures.append(f"{tag}: {launched} graph launches per chunk, not 1")


def _graph_counts():
    """(captures, replays) of the three graphed verification programs."""
    from cslam_tpu_torch.ops import registration as reg
    from cslam_tpu_torch.ops import visual_registration as vreg
    return {g.name: (g.captures, g.replays) for g in (
        reg.VERIFY_GRAPHS, vreg.ALIGN_GRAPHS, vreg.PNP_GRAPHS)}


def _graph_delta(before, tag, failures, chunks=None):
    """Captures and replays since ``before`` (a :func:`_graph_counts`) on
    a main path that ran after its warmup. Limits: no capture; replays >=
    ``chunks`` where given, else at least one."""
    after = _graph_counts()
    delta = {k: {"captures": after[k][0] - before[k][0],
                 "replays": after[k][1] - before[k][1]} for k in after}
    captures = sum(d["captures"] for d in delta.values())
    replays = sum(d["replays"] for d in delta.values())
    if captures:
        failures.append(f"{tag}: {captures} graph captures after warmup "
                        f"({delta})")
    if replays < (chunks if chunks is not None else 1):
        failures.append(f"{tag}: {replays} graph replays for {chunks} "
                        f"chunks")
    return delta


def _lidar_verify(failures, device="cuda"):
    """Part ``verify``: one ``_verify_pair_batch`` chunk of 8 pairs at
    pad_size 1024 through ``compute_transform_batch_begin``/``_step`` (its
    first call captures the tier's CUDA graph): the 4 revisits must pass
    within 0.1 m and 1 degree of ground truth, the 4 cross-scene pairs
    must be rejected, and the graphed success flags must equal the CPU's.
    Then the same chunk graphed and eager on the card
    (:func:`_graph_vs_eager`): equal inliers and flags, T's difference,
    times, the production call's wall per chunk, the graph pool's bytes,
    host syncs, and last each path's CUDA kernels, ``cudaGraphLaunch``
    calls, device time and idle share (``torch.profiler``)."""
    import math

    import numpy as np
    import torch

    from cslam_tpu_torch.ops import registration as reg
    from cslam_tpu_torch.utils import profiling
    pairs, truth = _verify_pairs(np.random.default_rng(3))
    profiling.reset_spans()
    t0 = time.perf_counter()
    handles = reg.compute_transform_batch_begin(pairs, 0.4, 40,
                                                pad_size=1024, device=device)
    for h in handles:
        reg.compute_transform_batch_step(h)
    first_s = time.perf_counter() - t0
    results = [r for h in handles for r in h.results]
    ok = [s for _, s in results]
    out = {"pairs": len(pairs), "points": [len(s) for s, _ in pairs],
           "success": ok, "first_call_s": first_s,
           "icp_gate_pass": profiling.counters().get("verify.icp_gate_pass")}
    errs = []
    for (Z, _), gt in zip(results[:4], truth):
        dR = Z[:3, :3].T @ gt[:3, :3]
        errs.append((float(np.linalg.norm(Z[:3, 3] - gt[:3, 3])),
                     math.degrees(math.acos(min(1.0, max(
                         -1.0, (np.trace(dR) - 1.0) / 2.0))))))
    out["revisit_err_m_deg"] = errs
    if ok != [True] * 4 + [False] * 4:
        failures.append(f"lidar verify: success flags {ok}")
    if not all(e_t <= _TRANS_TOL_M and e_r <= _ROT_TOL_DEG
               for e_t, e_r in errs):
        failures.append(f"lidar verify: revisit errors {errs}")
    t0 = time.perf_counter()
    cpu = reg.compute_transform_batch(pairs, 0.4, 40, pad_size=1024,
                                      device="cpu")
    out["cpu_s"] = time.perf_counter() - t0
    out["cpu_success"] = [s for _, s in cpu]
    if out["cpu_success"] != ok:
        failures.append(f"lidar verify: CPU flags {out['cpu_success']} "
                        f"differ from CUDA {ok}")

    operands = list(reg._pair_tensors(pairs, 1024, device)) + [
        torch.tensor(np.float32(v), device=device) for v in (0.6, 40, 0.6)]
    rec, graph, eager = _graph_vs_eager("lidar verify", reg.VERIFY_GRAPHS,
                                        operands, failures)
    out.update(rec)
    graph_flags = graph()[2].cpu().tolist()
    out["graph_success_equal_cpu"] = graph_flags == out["cpu_success"]
    if not out["graph_success_equal_cpu"]:
        failures.append(f"lidar verify: graphed flags {graph_flags} differ "
                        f"from the CPU's {out['cpu_success']}")

    def production():
        for h in reg.compute_transform_batch_begin(
                pairs, 0.4, 40, pad_size=1024, device=device):
            reg.compute_transform_batch_step(h)
    production()
    t0 = time.perf_counter()
    for _ in range(5):
        production()
    out["production_wall_ms_per_chunk"] = (time.perf_counter() - t0) * 200
    _graph_profiles("lidar verify", out, graph, eager, failures)
    print("  verify " + json.dumps(out))
    return out


def _mission_checks(tag, out, failures, device="cuda"):
    """The limits of a mission run by the scale tools
    (``tools/{lidar,visual}_e2e_scale.run_mission``): at least one
    verified inter-robot loop; robot 0's optimized ATE <= its odometry ATE
    + 0.05 m; on the card K1 launched and no CUDA graph captured on the
    main thread after the warmup (verification tiers, PGO and MAC
    programs; a MAC prefetch thread's captures are reported)."""
    if out["inter_robot_loops"] < 1:
        failures.append(f"{tag}: no verified inter-robot loop")
    if not out["ate_optimized_m"] <= out["ate_odometry_m"] + 0.05:
        failures.append(f"{tag}: optimized ATE {out['ate_optimized_m']} > "
                        f"odometry ATE {out['ate_odometry_m']} + 0.05")
    if device == "cpu":
        return
    if out["k1_launches"] < 1:
        failures.append(f"{tag}: K1 not launched")
    if out["captures_after_warmup"]:
        failures.append(f"{tag}: {out['captures_after_warmup']} graph "
                        f"captures after the warmup "
                        f"({out['graphs']['by_set']})")


def _print_mission(label, out):
    """The mission's report (its span table was printed by the tool)."""
    print(f"  {label} " + json.dumps(
        {k: v for k, v in out.items() if k not in ("spans", "nodes")}))


def _lidar_mission(failures, robots=3, steps=40, device="cuda",
                   points=4096, scenes=40, drain=60):
    """Part ``mission``: ``tools/lidar_e2e_scale.run_mission``, the twin of
    ``benchmarks/lidar_e2e_scale_bench.py`` (its widths: 4096 points per
    scan, 40 scenes, voxel 0.4 m, pad 1024, pair chunks up to 8, 20 x 60
    descriptors and 10 candidates, registration_min_inliers 40,
    similarity_threshold 0.7), on the card at a reduced depth (``robots``
    x ``steps``; the bench runs 5 x 210, phase ``scale``) with the MAC and
    PGO tier floors at their config defaults; the scan-context banks on
    the fused stage 1, so that every search goes through K1. Limits
    (:func:`_mission_checks`): a verified loop, the ATE bar, K1 launched,
    no capture after the warmup; every verification chunk a replay, and
    the warmup's verification graphs one per pair tier. The mission dumps
    its aggregate graphs (``CSLAM_TPU_DUMP_PGO``), whose largest is
    replayed graphed and eagerly (:func:`_pgo_dump_replay`)."""
    import tempfile

    from cslam_tpu_torch.ops import registration as reg
    from cslam_tpu_torch.tools import lidar_e2e_scale
    with tempfile.TemporaryDirectory(prefix="cslam_pgo_dump_") as dumps:
        out = lidar_e2e_scale.run_mission(robots, steps, scenes, points,
                                          device, pins=False, drain=drain,
                                          dump_dir=dumps)
        out["pgo_dumps"] = _pgo_dump_replay(dumps, failures, "lidar mission",
                                            device)
    out.pop("nodes")
    out["cuts"] = {"robots": f"{robots} (bench 5)",
                   "steps": f"{steps} (bench 210)",
                   "tier floors": "config defaults (bench pins MAC mf/P/E "
                                  "and PGO np/ne at 2048: phase scale)"}
    chunks = int(out["spans"].get("verify.dispatch", {}).get("count", 0))
    verify = out["graphs"]["by_set"][reg.VERIFY_GRAPHS.name]
    out["verify_chunks"] = chunks
    out["graphs_warmed"] = reg.VERIFY_GRAPHS.captures - verify["captures"]
    out["verify_batch_s"] = out["spans"].get("lidar.verify_batch", {}).get(
        "total_s")
    _print_mission("mission", out)
    _mission_checks("lidar mission", out, failures, device)
    if device == "cpu":         # no graph: the chunks run eagerly
        return out
    if out["graphs_warmed"] != 4:
        failures.append(f"lidar mission: {out['graphs_warmed']} "
                        "verification graphs after the warmup of tiers "
                        "(1, 2, 4, 8)")
    if verify["replays"] < chunks:
        failures.append(f"lidar mission: {verify['replays']} graph replays "
                        f"for {chunks} chunks")
    return out


def phase_lidar(results, failures, robots=3, steps=40):
    """The lidar path on the card: ``sc_search`` (the 65,536-scan bank,
    fused and unfused stage 1, K1 on the augmented rows), ``verify`` (one
    8-pair verification chunk) and ``mission`` (the node stack)."""
    out = results["lidar"] = {}
    out["sc_search"] = _lidar_search(failures)
    out["verify"] = _lidar_verify(failures)
    out["mission"] = _lidar_mission(failures, robots, steps)


# -- phases scale and gnc_sweep -----------------------------------------------

#: the JAX package's quick sweep (``benchmarks/gnc_scenario_sweep.py
#: --quick``) on the CPU, its summary line (PERF.md §6): the bar
#: the port's sweep is held to (no JAX runs here)
_JAX_QUICK_SWEEP = {"scenarios": 10, "false_rejected": 0,
                    "missed_outliers": 0, "ate_regressions": 0}


def phase_scale(results, failures, robots=5, steps=210):
    """``tools/lidar_e2e_scale.run_mission`` at the bench's own size and
    pins (5 x 210 keyframes, 40 scenes of 4,096 points; MAC's mf, P and E
    floors and PGO's pose and edge floors at 2,048, the bounded candidate
    pool; the port's warmup of exactly the tiers those pins reach). Limits:
    :func:`_mission_checks` (a verified loop, the ATE bar, K1 launched, no
    capture after the warmup) and the Woodbury tier's kernels (E1, E2, the
    WHILE node) launched."""
    from cslam_tpu_torch.tools import lidar_e2e_scale
    out = lidar_e2e_scale.run_mission(robots, steps, device="cuda",
                                      pins=True)
    out.pop("nodes")
    out["cuts"] = {} if (robots, steps) == (5, 210) else {
        "robots": f"{robots} (bench 5)", "steps": f"{steps} (bench 210)"}
    _print_mission("scale", out)
    _mission_checks("scale mission", out, failures)
    small = out["small_linalg_launches"]
    if not (small["eigh"] and small["svd"] and out["while_launches"]):
        failures.append(f"scale mission: the Woodbury tier's kernels did "
                        f"not run ({small}, {out['while_launches']} while "
                        "launches)")
    if not out.get("segment_sum_launches"):
        failures.append("scale mission: no segment-sum kernel launch")
    results["scale"] = out


def _sweep_tiers(tiers):
    """The distinct (pose tier, edge tier) of the sweep's graphs."""
    import numpy as np

    from cslam_tpu_torch.tools import gnc_scenario_sweep as sweep
    shapes = set()
    for (nr, npo, le, _, intra, _), n_out, seed in sweep.scenarios(tiers):
        graph, *_ = sweep.build_scenario(
            np.random.default_rng(1000 * seed + n_out), nr, npo, le, n_out,
            intra)
        a = graph.to_arrays(device="cpu")
        shapes.add((a.num_nodes, a.num_edges))
    return sorted(shapes)


def phase_gnc_sweep(results, failures):
    """``tools/gnc_scenario_sweep`` at its ``QUICK_TIERS`` (3 x 80 and 5 x
    100 poses, 10 scenarios) on the card, each scenario graphed and eager,
    after a back end's warmup of the sweep's GNC tiers. Limits: graphed
    and eager reject the same edges in every scenario; 0 missed outliers
    and 0 ATE regressions in each mode; false rejections no more than the
    JAX package's CPU sweep of the same scenarios; no capture after the
    warmup."""
    from cslam_tpu_torch.runtime import (DecentralizedPGO, MessageBus,
                                         RobotContext, VirtualClock)
    from cslam_tpu_torch.tools import gnc_scenario_sweep as sweep
    from cslam_tpu_torch.tools import harness
    t0 = time.perf_counter()
    backend = DecentralizedPGO(RobotContext(MessageBus(), VirtualClock(), 0, {
        "robot_id": 0, "max_nb_robots": 1}), synchronous_optimization=True,
        device="cuda")
    shapes = _sweep_tiers(sweep.QUICK_TIERS)
    for np_tier, ne_tier in shapes:
        backend.warmup_tier(np_tier, ne_tier)
    _sync()
    warm_s = time.perf_counter() - t0
    before = harness.graph_counts()
    res = sweep.sweep(sweep.QUICK_TIERS, "cuda", ("graphed", "eager"),
                      emit=lambda line: print("  gnc_sweep " + line))
    graphs = harness.graph_delta(before)
    out = {"tiers": "QUICK_TIERS", "warmed_tiers": shapes, "warmup_s": warm_s,
           "summary": res["summary"], "same_rejected": res["same_rejected"],
           "captures": graphs["captures"], "jax_cpu": _JAX_QUICK_SWEEP,
           "cuts": {}}
    print("  gnc_sweep " + json.dumps(out))
    if not all(res["same_rejected"]) or not res["same_rejected"]:
        failures.append(f"gnc_sweep: graphed and eager reject other edges "
                        f"({res['same_rejected']})")
    for mode, totals in res["summary"].items():
        if totals["missed_outliers"] or totals["ate_regressions"]:
            failures.append(f"gnc_sweep ({mode}): {totals}")
        if totals["false_rejected"] > _JAX_QUICK_SWEEP["false_rejected"]:
            failures.append(f"gnc_sweep ({mode}): {totals['false_rejected']} "
                            "false rejections, the JAX package's CPU sweep "
                            f"{_JAX_QUICK_SWEEP['false_rejected']}")
    if graphs["captures"]:
        failures.append(f"gnc_sweep: {graphs['captures']} captures after "
                        f"the warmup ({graphs['by_set']})")
    results["gnc_sweep"] = out


# -- phase visual -----------------------------------------------------------
# ``benchmarks/visual_e2e_scale_bench.py``'s frames and camera
_VIS_W, _VIS_H = 320, 240
_VIS_CAM = {"fx": 300.0, "fy": 300.0, "cx": 160.0, "cy": 120.0}
_VIS_ROT_TOL_DEG, _VIS_TRANS_TOL_M = 1.0, 0.05   # visual_verify: truth


def _vis_scene(seed, n=None, size=(_VIS_W, _VIS_H)):
    """``visual_e2e_scale_bench.make_scene`` (``tools/visual_e2e_scale``):
    a textured landmark field with a scene-distinct global appearance.
    Returns (points, textures, background of ``size`` = (width, height)
    pixels, half size)."""
    from cslam_tpu_torch.tools.visual_e2e_scale import make_scene
    return make_scene(seed, n, size)


def _vis_test_world(seed, n=120):
    """``tests/test_visual_frontend.make_world`` as a scene of
    :func:`_vis_render` (uniform background 10, 11 x 11 stamps)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                    rng.uniform(4, 10, n)], axis=1)
    tex = rng.integers(30, 255, (n, 11, 11), dtype=np.int64)
    return pts, tex, np.full((_VIS_H, _VIS_W), 10, np.uint8), 5


def _vis_render(scene, pose, cam=None):
    """``visual_e2e_scale_bench.render`` (``tools/visual_e2e_scale``):
    painter's-algorithm stamps in the camera at ``pose`` (``cam``: fx, fy,
    cx, cy; the bench's by default), at the size of the scene's
    background; returns (grayscale image, metric depth)."""
    from cslam_tpu_torch.tools.visual_e2e_scale import render
    return render(scene, pose, cam)


def _pose_xyz_yaw(x, y, z=0.0, yaw=0.0):
    from cslam_tpu_torch.tools.harness import pose_xyz_yaw
    return pose_xyz_yaw(x, y, z, yaw)


def _pose_errors(got, truth):
    """(rotation error in degrees, translation error in m) of each ``[4,
    4]`` estimate against its truth."""
    import math

    import numpy as np
    out = []
    for G, W in zip(got, truth):
        dR = np.asarray(G)[:3, :3].T @ W[:3, :3]
        out.append((math.degrees(math.acos(min(1.0, max(
            -1.0, (np.trace(dR) - 1.0) / 2.0)))),
            float(np.linalg.norm(np.asarray(G)[:3, 3] - W[:3, 3]))))
    return out


def _verification_chunks(rng, P=16, n=200, slots=512):
    """``benchmarks/verification_bench.py``'s chunk (P pairs, ``n`` of
    ``slots`` correspondences live, every fifth an outlier moved 2-5 m)
    and, for the same P poses and outlier slots, a projective chunk: ``n``
    pixels of the bench's 320 x 240 camera at 3-12 m in the local frame,
    the remote points mapped through the pose's inverse, the outliers'
    pixels moved 40-200 px and their local points 2-5 m. Returns (3D-3D
    arrays, PnP arrays, the P ground-truth transforms)."""
    import numpy as np
    src = np.zeros((P, slots, 3), np.float32)
    dst = np.zeros((P, slots, 3), np.float32)
    valid = np.zeros((P, slots), np.float32)
    p3d = np.zeros((P, slots, 3), np.float32)
    uv = np.zeros((P, slots, 2), np.float32)
    init = np.zeros((P, slots, 3), np.float32)
    fx, fy, cx, cy = (_VIS_CAM[k] for k in ("fx", "fy", "cx", "cy"))
    truth = []
    for i in range(P):
        pts = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
        angle = rng.uniform(-0.5, 0.5)
        c, s = np.cos(angle), np.sin(angle)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        t = rng.uniform(-1, 1, 3).astype(np.float32)
        moved = pts @ R.T + t
        moved[::5] += rng.uniform(2, 5, (len(moved[::5]), 3))
        src[i, :n], dst[i, :n], valid[i, :n] = pts, moved, 1.0
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, t
        truth.append(T)
        # projective: local pixels and depths, remote points = T^-1 p_local
        pix = np.stack([rng.uniform(0, _VIS_W, n), rng.uniform(0, _VIS_H, n)],
                       1)
        z = rng.uniform(3, 12, n)
        local = np.stack([(pix[:, 0] - cx) * z / fx,
                          (pix[:, 1] - cy) * z / fy, z], 1)
        p3d[i, :n] = (local - t) @ R          # R^T (p - t), row form
        uv[i, :n] = pix + rng.normal(scale=0.3, size=pix.shape)
        uv[i, :n:5] += rng.uniform(40, 200, (len(uv[i, :n:5]), 2))
        init[i, :n] = local
        init[i, :n:5] += rng.uniform(2, 5, (len(init[i, :n:5]), 3))
    return (src, dst, valid), (p3d, uv, valid.copy(), init), truth


def _visual_verify(failures, device="cuda"):
    """Part ``visual_verify``: one 16-pair chunk at
    ``benchmarks/verification_bench.py``'s widths through
    ``gnc_align_batch`` (12 GNC iterations, inlier distance 0.3 m), then
    the same poses as a projective chunk through ``gnc_pnp_batch`` (24
    iterations, 4 px); each call on the card replays the tier's CUDA
    graph, captured at the first. Limits: every pair within 1 degree and
    0.05 m of the truth; inlier counts equal to the same call on the CPU;
    the graphed chunk's inliers equal to the eager chunk's on the card (T's
    difference printed); no host sync inside a graphed chunk. Then each
    path's time per chunk (CUDA events, warm), peak memory and the graph
    pool's bytes, and last each path's CUDA kernels, ``cudaGraphLaunch``
    calls, device time and idle share (``torch.profiler``)."""
    import numpy as np
    import torch

    from cslam_tpu_torch.ops import visual_registration as vreg
    rigid, pnp, truth = _verification_chunks(np.random.default_rng(0))
    cam = [_VIS_CAM[k] for k in ("fx", "fy", "cx", "cy")]
    chunks = {
        "gnc_align_batch": lambda dev: vreg.gnc_align_batch(
            *rigid, 0.3, iters=12, device=dev),
        "gnc_pnp_batch": lambda dev: vreg.gnc_pnp_batch(
            *pnp, *cam, inlier_px=4.0, iters=24, device=dev)}
    out = {"pairs": len(truth), "live_correspondences": 200,
           "slots": vreg.MAX_CORRESPONDENCES, "outliers": 0.2}
    calls = {}
    for name, run in chunks.items():
        rec = out[name] = {}
        T, inl = run(device)
        _sync()
        T_cpu, inl_cpu = run("cpu")
        errs = _pose_errors(T.cpu().numpy(), truth)
        rec["max_rot_err_deg"] = max(e[0] for e in errs)
        rec["max_trans_err_m"] = max(e[1] for e in errs)
        rec["inliers"] = inl.cpu().tolist()
        rec["inliers_equal_cpu"] = rec["inliers"] == inl_cpu.tolist()
        rec["max_abs_T_diff_cpu"] = float((T.cpu() - T_cpu).abs().max())
        if not all(r <= _VIS_ROT_TOL_DEG and t <= _VIS_TRANS_TOL_M
                   for r, t in errs):
            failures.append(f"visual_verify {name}: pose errors {errs}")
        if not rec["inliers_equal_cpu"]:
            failures.append(f"visual_verify {name}: inliers {rec['inliers']}"
                            f" differ from the CPU's {inl_cpu.tolist()}")
        arrays, extra, iters = ((rigid, [0.3], 12)
                                if name == "gnc_align_batch"
                                else (pnp, cam + [4.0], 24))
        operands = [torch.as_tensor(a, device=device) for a in arrays] + [
            torch.tensor(np.float32(v), device=device) for v in extra]
        graphs = (vreg.ALIGN_GRAPHS if name == "gnc_align_batch"
                  else vreg.PNP_GRAPHS)
        got, graph, eager = _graph_vs_eager(
            f"visual_verify {name}", graphs, operands, failures, 10,
            iters=iters)
        rec.update(got)
        calls[name] = (graph, eager)
    # the profiler last: its tracing may slow what runs after it
    for name, (graph, eager) in calls.items():
        _graph_profiles(f"visual_verify {name}", out[name], graph, eager,
                        failures)
    print("  visual_verify " + json.dumps(out))
    return out


def _visual_mission(failures, robots=3, steps=40, device="cuda", scenes=40,
                    drain=60, threshold=0.998, sensor="rgbd"):
    """Part ``visual_mission``: ``tools/visual_e2e_scale.run_mission``, the
    twin of ``benchmarks/visual_e2e_scale_bench.py`` (320 x 240 rendered
    RGB-D frames of 40 scenes, drifting odometry, every frame a keyframe,
    CosPlace ResNet18 + GeM at crop 224 on the port's seeded golden
    weights), on ``device`` at a reduced depth (``robots`` x ``steps``;
    the bench runs 5 x 210) with the MAC and PGO tier floors at their
    config defaults; with ``sensor="stereo"`` the same with rendered stereo
    pairs (0.2 m baseline) through the ``StereoFrontEnd`` that
    ``make_map_manager`` builds. Limits: the C++ feature library loaded,
    and :func:`_mission_checks`."""
    from cslam_tpu_torch.tools import visual_e2e_scale
    out = visual_e2e_scale.run_mission(robots, steps, scenes, device,
                                       pins=False, drain=drain,
                                       threshold=threshold, sensor=sensor)
    out.pop("nodes")
    out["cuts"] = {"robots": f"{robots} (bench 5)",
                   "steps": f"{steps} (bench 210)",
                   "tier floors": "config defaults (bench pins MAC mf/P/E "
                                  "and PGO np/ne at 2048)"}
    rgbd = out["spans"].get("rgbd.verify_batch", {})
    out["verify_batch_s"] = rgbd.get("total_s")
    out["verify_batch_calls"] = rgbd.get("count")
    tag = f"visual mission ({sensor})"
    _print_mission(f"visual_mission {sensor}", out)
    if not out["native_available"]:
        failures.append(f"{tag}: the C++ feature library is not loaded")
    _mission_checks(tag, out, failures, device)
    by_set = out["graphs"]["by_set"]
    replays = sum(by_set[k]["replays"] for k in (
        "visual_registration.gnc_align_batch",
        "visual_registration.gnc_pnp_batch"))
    if device != "cpu" and replays < 1:
        failures.append(f"{tag}: no verification chunk replayed a graph")
    return out


def _stereo_exchange(device):
    """Two stereo robots built by ``make_map_manager`` (``sensor_type:
    stereo``, baseline 0.2 m) on the rendered pairs of
    ``tests/test_visual_frontend.py``'s stereo cases (its world, seed 6):
    robot 1 ships its keyframe to robot 0's. Returns the closures and the
    ground-truth relative pose."""
    import numpy as np

    from cslam_tpu_torch.runtime import (CameraModel, MessageBus,
                                         RobotContext, VirtualClock,
                                         make_map_manager)
    from cslam_tpu_torch.types import LocalDescriptorsRequest, Odometry
    cam = CameraModel(**_VIS_CAM, baseline=0.2)
    world = _vis_test_world(6)
    poses = [_pose_xyz_yaw(0, 0, 0), _pose_xyz_yaw(0.3, -0.2, 0.0, yaw=0.08)]
    bus, clock = MessageBus(), VirtualClock()
    fes = []
    for rid, X in enumerate(poses):
        ctx = RobotContext(bus, clock, rid, {
            "robot_id": rid, "max_nb_robots": 2,
            "frontend.sensor_type": "stereo",
            "frontend.map_manager_process_period_ms": 100})
        fe = make_map_manager(ctx, cam, device=device)
        left, _ = _vis_render(world, X)
        right, _ = _vis_render(world, X @ _pose_xyz_yaw(cam.baseline, 0, 0))
        fe.stereo_callback(left, right, Odometry(pose=X))
        fes.append(fe)
    clock.advance(0.2)
    for fe in fes:
        fe.ctx.poll_timers()
    bus.deliver()
    closures = []
    bus.subscribe("/cslam/inter_robot_loop_closure", closures.append)
    bus.publish("/r1/cslam/local_descriptors_request",
                LocalDescriptorsRequest(keyframe_id=0, matches_robot_id=[0],
                                        matches_keyframe_id=[0]))
    bus.deliver()
    return ([type(fe).__name__ for fe in fes], closures,
            np.linalg.inv(poses[0]) @ poses[1])


def _visual_stereo(failures, device="cuda", robots=3, steps=20):
    """Part ``visual_stereo``: the two-robot stereo exchange on ``device``
    and on the CPU (limits: a closure, verified, with the CPU's flags, its
    translation within 0.12 m of the truth); then the visual mission's
    stereo variant at ``robots`` x ``steps`` (its limits)."""
    import numpy as np
    kinds, got, truth = _stereo_exchange(device)
    _, cpu, _ = _stereo_exchange("cpu")
    out = {"front_ends": kinds, "success": [c.success for c in got],
           "cpu_success": [c.success for c in cpu]}
    if got and got[0].success:
        out["trans_err_m"] = float(np.linalg.norm(
            got[0].transform[:3, 3] - truth[:3, 3]))
    print("  visual_stereo " + json.dumps(out))
    if kinds != ["StereoFrontEnd"] * 2:
        failures.append(f"visual stereo: make_map_manager built {kinds}")
    if out["success"] != [True] or out["cpu_success"] != out["success"]:
        failures.append(f"visual stereo: flags {out['success']} (CPU "
                        f"{out['cpu_success']})")
    elif not out["trans_err_m"] <= 0.12:
        failures.append(f"visual stereo: translation error "
                        f"{out['trans_err_m']} m")
    out["mission"] = _visual_mission(failures, robots, steps, device,
                                     drain=40, sensor="stereo")
    return out


def phase_visual(results, failures, robots=3, steps=40):
    """The visual (RGB-D / stereo) path on the card: ``visual_verify`` (one
    16-pair 3D-3D chunk and one projective chunk), ``visual_mission`` (the
    RGB-D node stack) and ``visual_stereo`` (two stereo front ends)."""
    out = results["visual"] = {}
    out["visual_verify"] = _visual_verify(failures)
    out["visual_mission"] = _visual_mission(failures, robots, steps)
    out["visual_stereo"] = _visual_stereo(failures)


# -- phase deploy -----------------------------------------------------------
# KITTI odometry sequence 00's published calibration (calib.txt: P0, and P1's
# baseline) and image size; one Velodyne HDL-64E sweep is about 120,000 points
_KITTI_CAM = {"fx": 718.856, "fy": 718.856, "cx": 607.1928, "cy": 185.2157}
_KITTI_BASELINE = 0.5372
_KITTI_SIZE = (1241, 376)
_HDL64_POINTS = 120000


def _deploy_track(robots, frames, scenes, offset):
    """Scene visited and ground-truth pose of each robot's frames: robot r
    sees scene (i + 5 r) mod ``scenes`` at its frame i (so every robot
    revisits the places the others saw), from ``offset(r)`` off the scene's
    origin on a 7 m grid (the missions' layout)."""
    grid = [_pose_xyz_yaw(7.0 * (s % 8), 7.0 * (s // 8))
            for s in range(scenes)]
    return {r: [((i + 5 * r) % scenes, grid[(i + 5 * r) % scenes] @ offset(r))
                for i in range(frames)] for r in range(robots)}, grid


def _kitti_stereo_sequences(root, robots=2, frames=20, scenes=20,
                            landmarks=300):
    """Two KITTI-layout stereo sequences (``image_0``/``image_1`` grayscale
    PNGs at 1241 x 376, ``calib.txt`` with sequence 00's P0 and P1,
    ``poses.txt``, ``times.txt``), written by the port's
    ``write_kitti_sequence``: rendered landmark scenes
    (``_vis_scene``/``_vis_render`` at KITTI's camera). Returns the
    directories."""
    import os

    from cslam_tpu_torch.runtime.replay import write_kitti_sequence
    track, grid = _deploy_track(
        robots, frames, scenes,
        lambda r: _pose_xyz_yaw(0.25 * r, 0.1 * r, 0.1 * r, yaw=0.04 * r))
    world = []
    for s in range(scenes):
        pts, tex, bg, half = _vis_scene(3000 + s, n=landmarks,
                                        size=_KITTI_SIZE)
        world.append((pts @ grid[s][:3, :3].T + grid[s][:3, 3], tex, bg,
                       half))
    right = _pose_xyz_yaw(_KITTI_BASELINE, 0.0)
    dirs = []
    for r in range(robots):
        lefts, rights, poses = [], [], []
        for s, pose in track[r]:
            lefts.append(_vis_render(world[s], pose, _KITTI_CAM)[0])
            rights.append(_vis_render(world[s], pose @ right, _KITTI_CAM)[0])
            poses.append(pose)
        d = os.path.join(root, f"stereo_{r:02d}")
        write_kitti_sequence(d, lefts, rights, poses, baseline=_KITTI_BASELINE,
                             times=[0.1 * i for i in range(frames)],
                             **_KITTI_CAM)
        dirs.append(d)
    return dirs


def _parked_cars(rng, n_cars, n_points):
    """Clutter: ``n_cars`` boxes of 4.4 x 1.8 x 1.5 m within 12 m of the
    sensor, at random yaws, ``n_points`` in all on their faces."""
    import numpy as np
    half = np.array([2.2, 0.9, 0.75])
    out = []
    for n in np.diff(np.linspace(0, n_points, n_cars + 1).astype(int)):
        u = rng.uniform(-1, 1, (n, 3))
        face = rng.integers(0, 3, n)
        u[np.arange(n), face] = np.where(rng.random(n) < 0.5, -1.0, 1.0)
        u *= half
        yaw = rng.uniform(0, np.pi)
        rot = np.array([[np.cos(yaw), -np.sin(yaw)],
                        [np.sin(yaw), np.cos(yaw)]])
        xy = u[:, :2] @ rot.T + rng.uniform(-12, 12, 2)
        out.append(np.concatenate([xy, u[:, 2:] + half[2]], 1))
    return np.concatenate(out)


def _kitti_lidar_sequences(root, robots=2, frames=20, scenes=20,
                           points=_HDL64_POINTS, scene_points=4096,
                           n_cars=4):
    """Two KITTI-layout lidar sequences (``velodyne/*.bin`` sweeps of
    ``points`` points, x/y/z/intensity float32; ``poses.txt``). A scene is
    ``_scene_cloud`` at ``scene_points`` (the lidar bench's width): its
    walls, ground returns and pillars are the surfaces a sweep samples.
    Each sweep returns (``points`` - 1,200) // ``scene_points`` samples
    within 3 cm of every scene point, seen from the robot's pose with 3 cm
    noise, plus ``_parked_cars`` (``n_cars`` boxes, a new draw every sweep)
    filling it to ``points``. Returns the directories."""
    import os

    import numpy as np

    from cslam_tpu_torch.runtime.replay import write_kitti_sequence
    per_point = (points - 1200) // scene_points
    n_clutter = points - per_point * scene_points
    track, grid = _deploy_track(
        robots, frames, scenes, lambda r: _pose_at(0.3 * r, 0.2 * r,
                                                   yaw=0.1 * r))
    world = [_scene_cloud(2000 + s, scene_points) @ grid[s][:3, :3].T
             + grid[s][:3, 3] for s in range(scenes)]
    rng = np.random.default_rng(5)
    dirs = []
    for r in range(robots):
        scans, poses = [], []
        for s, pose in track[r]:
            dense = np.repeat(world[s], per_point, 0)
            dense += rng.normal(scale=0.03, size=dense.shape)
            scan = np.concatenate([_observe(dense, pose, rng),
                                   _parked_cars(rng, n_cars, n_clutter)])
            scans.append(np.concatenate(
                [scan, rng.random((points, 1))], 1).astype(np.float32))
            poses.append(pose)
        d = os.path.join(root, f"lidar_{r:02d}")
        write_kitti_sequence(d, None, None, poses, scans=scans,
                             times=[0.1 * i for i in range(frames)])
        dirs.append(d)
    return dirs


def _dense_ground_probe(device, voxel=0.4, points=_HDL64_POINTS, pairs=4):
    """What the verification does with ``_scene_cloud`` drawn at the full
    sweep size, whose ground scatter then fills about 95% of the 0.4 m
    voxels (13,600 of 14,400): the keyframe cloud is cut to 1,024 points
    by a stride (``registration.pad_cloud``), as in the JAX package. Each
    of ``pairs`` scenes is verified against itself from another pose (a
    true pair) and against the next scene (a false pair). No limit: a
    known weakness, printed and recorded."""
    import numpy as np

    from cslam_tpu_torch.ops import registration
    rng = np.random.default_rng(9)
    pa, pb = _pose_at(0.0, 0.0), _pose_at(0.3, 0.2, yaw=0.1)
    truth = np.linalg.inv(pa) @ pb
    out = {"voxel_m": voxel, "points": points, "voxels": [],
           "true_verified": 0, "true_errors_m": [], "false_verified": 0}
    for s in range(pairs):
        a, b, c = (registration.voxel_downsample(_observe(
            _scene_cloud(seed, points), pose, rng), voxel) for seed, pose in (
                (2000 + s, pa), (2000 + s, pb), (2001 + s, pb)))
        out["voxels"].append(len(a))
        T, ok = registration.compute_transform(a, b, voxel, 40, device=device)
        if ok:        # the error in either direction of the transform
            out["true_verified"] += 1
            out["true_errors_m"].append(float(min(
                np.linalg.norm(M[:3, 3] - truth[:3, 3])
                for M in (np.asarray(T), np.linalg.inv(T)))))
        out["false_verified"] += int(registration.compute_transform(
            a, c, voxel, 40, device=device)[1])
    print("  dense_ground_probe " + json.dumps(out))
    return out


def _loop_errors(driver):
    """Translation error (m) of every verified inter-robot loop that the
    robots' back ends hold, against the sequences' ground truth."""
    import numpy as np
    errors = []
    for robot in driver.robots:
        for edges in robot.backend.inter_robot_loop_closures.values():
            for e in edges:
                (ra, ka), (rb, kb) = e.key_from.as_tuple(), e.key_to.as_tuple()
                truth = (np.linalg.inv(driver.robots[ra].kf_gt[ka])
                         @ driver.robots[rb].kf_gt[kb])
                errors.append(float(np.linalg.norm(
                    np.asarray(e.measurement)[:3, 3] - truth[:3, 3])))
    return errors


def _replay_record(driver, wall, launches, spans):
    """Per-robot outcome of a replay and its ATE; the verified loops'
    errors against the ground truth."""
    per_robot = []
    for rid, robot in enumerate(driver.robots):
        odo, opt = driver.ate(rid)
        per_robot.append({
            "robot": rid, "keyframes": robot.frontend.nb_local_keyframes,
            "fixed_edges": len(
                robot.detection.lcm.candidate_selector.fixed_edges),
            "inter_lc": sum(len(v) for v in
                            robot.backend.inter_robot_loop_closures.values()),
            "optimizations": robot.backend.optimization_count,
            "ate_odom": odo, "ate_opt": opt})
    errors = sorted(_loop_errors(driver))
    return {"wall_s": wall, "k1_launches": launches, "robots": per_robot,
            "loops": len(errors),
            "loops_within_0.1m": sum(e <= 0.1 for e in errors),
            "loop_error_median_m": (errors[len(errors) // 2] if errors
                                    else None),
            "spans": spans}


def _replay_checks(tag, rec, failures, device):
    r0 = rec["robots"][0]
    if sum(r["inter_lc"] for r in rec["robots"]) < 1:
        failures.append(f"{tag}: no verified inter-robot loop")
    if not r0["ate_opt"] <= r0["ate_odom"] + 0.05:
        failures.append(f"{tag}: optimized ATE {r0['ate_opt']} > odometry "
                        f"ATE {r0['ate_odom']} + 0.05")
    if device != "cpu" and rec["k1_launches"] < 1:
        failures.append(f"{tag}: K1 not launched")


def _print_replay(tag, rec):
    print(f"  {tag}: {rec['wall_s']:.1f} s wall, {rec['k1_launches']} K1 "
          f"launches, {rec['loops']} verified loops "
          f"({rec['loops_within_0.1m']} within 0.1 m of the truth, median "
          f"error {rec['loop_error_median_m']} m)")
    for r in rec["robots"]:
        print("  " + json.dumps(r))
    if rec.get("graphs"):
        print("  graphs " + json.dumps(rec["graphs"]))


_STEREO_OVERRIDES = {
    "frontend.warmup_verification_tiers": (1, 2, 4, 8, 16),
    "frontend.similarity_threshold": 0.95,
    "frontend.pnp_min_inliers": 10,
    "frontend.inter_robot_detection_period_sec": 1.0,
    "frontend.detection_publication_period_sec": 0.5,
    "backend.pose_graph_optimization_start_period_ms": 1500,
}
#: the stereo front end's state that a snapshot leaves out (it is the
#: sensor process's, which keeps running while detection and back end
#: restart); with the replay's own cursor and ground truth
_FRONT_END_STATE = ("features", "nb_local_keyframes", "previous_features",
                    "log_comm_bytes")
_REPLAY_STATE = ("cursor", "kf_gt", "odom_pose", "prev_gt")


def _deploy_stereo(failures, root, device="cuda", frames=20, dt=0.25,
                   extra_steps=30):
    """Part ``stereo_replay``: the port's ``ReplayDriver`` over two
    KITTI-layout stereo sequences at 1241 x 376 (sequence 00's camera),
    ``TinyImageDescriptor`` (the tool's default), on ``device``. Halfway
    through, every robot's detection front end and back end are snapshot
    (``utils.snapshot``) and restored into fresh nodes on the same device,
    and the replay goes on there; the same snapshot is then loaded into
    CPU nodes. Limits: at least one verified inter-robot loop; robot 0's
    optimized ATE <= odometry ATE + 0.05 m; K1 launched (on CUDA), and
    again after the restore; keyframes and fixed edges grow after the
    restore; the CPU nodes hold the same banks and find the same rows."""
    import os

    import numpy as np
    import torch

    from cslam_tpu_torch import native
    from cslam_tpu_torch.ops import nns
    from cslam_tpu_torch.runtime.replay import (KittiSequence, ReplayDriver,
                                                TinyImageDescriptor)
    from cslam_tpu_torch.utils import profiling
    from cslam_tpu_torch.utils.snapshot import restore_robot, snapshot_robot
    t0 = time.perf_counter()
    dirs = _kitti_stereo_sequences(root, frames=frames)
    written = time.perf_counter() - t0
    seqs = [KittiSequence(d) for d in dirs]

    def driver(dev):
        return ReplayDriver(seqs, odom_noise=0.05, seed=0,
                            config_overrides=_STEREO_OVERRIDES,
                            model=TinyImageDescriptor(), device=dev)
    native.available()                       # builds the library once
    first = driver(device)
    if device != "cpu":
        _sync()
    graphs_before = _graph_counts()
    profiling.reset_spans()
    nns.launches = 0
    t0 = time.perf_counter()
    while first.robots[0].cursor < frames // 2:      # the main path
        first.step(dt)
    paths = [os.path.join(root, f"r{rid}.snapshot")
             for rid in range(len(seqs))]
    for robot, path in zip(first.robots, paths):
        snapshot_robot(robot.detection, robot.backend, path)
    before = {"launches": nns.launches,
              "keyframes": first.robots[0].detection.lcm.local_nnsm.n,
              "fixed_edges": sum(
                  len(r.detection.lcm.candidate_selector.fixed_edges)
                  for r in first.robots),
              "sim_s": first.clock.now()}
    second = driver(device)
    for old, new, path in zip(first.robots, second.robots, paths):
        restore_robot(new.detection, new.backend, path)
        for name in _FRONT_END_STATE:
            setattr(new.frontend, name, getattr(old.frontend, name))
        for name in _REPLAY_STATE:
            setattr(new, name, getattr(old, name))
    second.rng = first.rng
    second.clock.advance(first.clock.now())
    second.run(extra_steps=extra_steps, dt=dt)
    if device != "cpu":
        _sync()
    wall = time.perf_counter() - t0
    graphs = (_graph_delta(graphs_before, "stereo replay", failures)
              if device != "cpu" else None)
    launches = nns.launches
    spans = {k: v for k, v in profiling.spans().items()
             if k.split(".")[0] in ("rgbd", "lcd", "nns")
             or k == "pgo.optimize"}
    print(profiling.report())
    rec = _replay_record(second, wall, launches, spans)
    after = {"launches": launches - before["launches"],
             "keyframes": second.robots[0].detection.lcm.local_nnsm.n,
             "fixed_edges": sum(
                 len(r.detection.lcm.candidate_selector.fixed_edges)
                 for r in second.robots)}
    # the same file into CPU nodes
    cpu = driver("cpu").robots[0]
    restore_robot(cpu.detection, cpu.backend, paths[0])
    bank, ref = cpu.detection.lcm.local_nnsm, first.robots[0].detection.lcm
    probe = ref.local_nnsm.data[:ref.local_nnsm.n]
    cpu_same = (bank.n == ref.local_nnsm.n
                and np.array_equal(bank.data[:bank.n], probe)
                and [bank.search_best(q)[0] for q in probe]
                == [ref.local_nnsm.search_best(q)[0] for q in probe]
                and set(cpu.backend.odometry_pose_estimates)
                == set(first.robots[0].backend.odometry_pose_estimates))
    rec.update({
        "frame": f"{_KITTI_SIZE[0]}x{_KITTI_SIZE[1]}", "camera": _KITTI_CAM,
        "baseline_m": _KITTI_BASELINE, "frames_per_robot": frames,
        "write_s": written, "snapshot_bytes": [os.path.getsize(p)
                                               for p in paths],
        "before_restore": before, "after_restore": after,
        "cpu_restore_same": cpu_same, "graphs": graphs})
    _print_replay("stereo_replay", rec)
    print("  snapshot " + json.dumps({k: rec[k] for k in (
        "snapshot_bytes", "before_restore", "after_restore",
        "cpu_restore_same")}))
    _replay_checks("stereo replay", rec, failures, device)
    if not native.available():
        failures.append("stereo replay: the C++ feature library is not "
                        "loaded")
    if device != "cpu" and after["launches"] < 1:
        failures.append("stereo replay: K1 not launched after the restore")
    if not (after["keyframes"] > before["keyframes"]
            and after["fixed_edges"] > before["fixed_edges"]):
        failures.append(f"stereo replay: no growth after the restore "
                        f"({before} -> {after})")
    if not cpu_same:
        failures.append("stereo replay: the snapshot restored into CPU "
                        "nodes differs")
    return rec


_LIDAR_OVERRIDES = {
    "frontend.similarity_threshold": 0.7,
    "frontend.keyframe_generation_ratio_distance": 0.5,
    "frontend.voxel_size": 0.4,
    "frontend.registration_min_inliers": 40,
    "frontend.inter_robot_detection_period_sec": 1.0,
    "frontend.detection_publication_period_sec": 0.5,
    "frontend.max_candidate_pool": 2048,
    "frontend.harvest_ready_gate": True,
    "frontend.scancontext_fused_stage1": True,
    "frontend.bank_initial_capacity": 4096,
    "backend.pose_graph_optimization_start_period_ms": 1500,
    "evaluation.enable_logs": True,
}


def _deploy_lidar(failures, root, device="cuda", frames=20,
                  points=_HDL64_POINTS, dt=0.25, extra_steps=30):
    """Part ``lidar_replay``: the port's ``LidarReplayDriver`` over two
    KITTI-layout velodyne sequences of ``points``-point sweeps, with the
    scan-context banks on the fused stage 1 (K1 on the augmented ring
    keys; ``bank_initial_capacity`` 4096) and the experiment logger on
    robot 0's back end. Limits: those of the stereo replay; K1 launched
    (through the scan-context bank: this path has no visual bank); the
    logger wrote ``metrics.csv`` and both g2o dumps, with a finite
    ``graph_error``."""
    import csv
    import os

    import torch

    from cslam_tpu_torch.evaluation import ExperimentLogger
    from cslam_tpu_torch.ops import nns
    from cslam_tpu_torch.runtime.replay import KittiSequence, LidarReplayDriver
    from cslam_tpu_torch.utils import profiling
    t0 = time.perf_counter()
    dirs = _kitti_lidar_sequences(root, frames=frames, points=points)
    written = time.perf_counter() - t0
    log_root = os.path.join(root, "logs")
    driver = LidarReplayDriver(
        [KittiSequence(d) for d in dirs], odom_noise=0.05, seed=0,
        config_overrides={**_LIDAR_OVERRIDES,
                          "evaluation.log_folder": log_root}, device=device)
    robot0 = driver.robots[0]
    # the JAX package's replay builds no logger; a deployment attaches one
    robot0.backend.logger = ExperimentLogger(robot0.ctx, log_root,
                                             device=device)
    robot0.frontend.warmup(pair_tiers=(1, 2, 4, 8))
    if device != "cpu":
        _sync()
    graphs_before = _graph_counts()
    profiling.reset_spans()
    nns.launches = 0
    t0 = time.perf_counter()
    driver.run(extra_steps=extra_steps, dt=dt)       # the main path
    if device != "cpu":
        _sync()
    wall = time.perf_counter() - t0
    chunks = int(profiling.spans().get("verify.dispatch", {}).get("count", 0))
    graphs = (_graph_delta(graphs_before, "lidar replay", failures, chunks)
              if device != "cpu" else None)
    launches = nns.launches
    spans = {k: v for k, v in profiling.spans().items()
             if k.split(".")[0] in ("lidar", "verify", "lcd", "nns")
             or k == "pgo.optimize"}
    print(profiling.report())
    rec = _replay_record(driver, wall, launches, spans)
    fused = [b._fused_stage1_ok() for b in
             robot0.detection.lcm.other_robots_nnsm.values()]
    folder = robot0.backend.logger.folder
    files = sorted(os.listdir(folder))
    with open(os.path.join(folder, "metrics.csv"), newline="") as f:
        rows = list(csv.DictReader(f))
    graph_error = float(rows[-1]["graph_error"]) if rows else float("nan")
    rec.update({"points_per_sweep": points, "frames_per_robot": frames,
                "write_s": written, "fused_stage1": fused,
                "log_files": len(files), "metrics_rows": len(rows),
                "graph_error": graph_error, "verify_chunks": chunks,
                "graphs": graphs})
    _print_replay("lidar_replay", rec)
    print("  logger " + json.dumps({"files": files[:4] + ["..."],
                                    "rows": len(rows),
                                    "graph_error": graph_error}))
    _replay_checks("lidar replay", rec, failures, device)
    rec["dense_ground_probe"] = _dense_ground_probe(device)
    if device != "cpu" and not all(fused):
        failures.append("lidar replay: a scan-context bank is not on the "
                        "fused stage 1")
    if not ("metrics.csv" in files
            and any(f.startswith("initial_global") for f in files)
            and any(f.startswith("optimized_global") for f in files)):
        failures.append(f"lidar replay: logger files missing ({files})")
    import math
    if not math.isfinite(graph_error):
        failures.append(f"lidar replay: graph_error {graph_error}")
    return rec


def _deploy_swarm(failures, device="cuda", robots=3, duration=20.0):
    """Part ``swarm_processes``: ``tools/multi_process_swarm.run_swarm``,
    the hub here and one robot per OS process, every robot on the one
    card, for ``duration`` s of wall clock. Limits: every robot process
    exits 0 with fixed edges > 0, K1 launched (on CUDA), at least one
    optimized result received (only the elected robot of a group solves;
    the swarm solved at least once), and neither ``jax`` nor ``cslam_tpu``
    in its ``sys.modules``; no frame carried a tensor (the transport
    refuses one, which would fail the robot)."""
    from cslam_tpu_torch.tools.multi_process_swarm import run_swarm
    t0 = time.perf_counter()
    results = run_swarm(robots=robots, duration=duration, device=device)
    wall = time.perf_counter() - t0
    rec = {"robots": results, "wall_s": wall, "duration_s": duration,
           "k1_launches": sum(r["k1_launches"] for r in results),
           "optimizations": sum(r["optimizations"] for r in results)}
    print(f"  swarm_processes {robots} x {duration:.0f} s: {wall:.1f} s "
          f"wall, {rec['k1_launches']} K1 launches in the robots")
    for r in results:
        print("  " + json.dumps(r))
    if rec["optimizations"] < 1:
        failures.append("swarm processes: no optimization")
    for r in results:
        tag = f"swarm processes: robot {r['robot']}"
        if r["fixed_edges"] < 1:
            failures.append(f"{tag}: no fixed edges")
        if r["optimized_results_received"] < 1:
            failures.append(f"{tag}: no optimized result")
        if device != "cpu" and r["k1_launches"] < 1:
            failures.append(f"{tag}: K1 not launched")
        if r["foreign_modules"]:
            failures.append(f"{tag}: imported {r['foreign_modules']}")
        if r["device"] != str(device):
            failures.append(f"{tag}: ran on {r['device']}")
    return rec


def phase_deploy(results, failures, device="cuda"):
    """The deployment entry points on the card: ``stereo_replay`` (with a
    snapshot and restore halfway), ``lidar_replay`` (with the experiment
    logger) and ``swarm_processes``."""
    import tempfile
    out = results["deploy"] = {}
    with tempfile.TemporaryDirectory(prefix="cslam_deploy_") as root:
        out["stereo_replay"] = _deploy_stereo(failures, root, device)
        out["lidar_replay"] = _deploy_lidar(failures, root, device)
    out["swarm_processes"] = _deploy_swarm(failures, device)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--phases",
        default="bank_scan,segment_sum,swarm,swarm_floored,large_tiers,"
                "distributed,frontend,lidar,visual,deploy,gnc_sweep,scale,"
                "mac_calls",
        help="comma-separated subset of bank_scan,segment_sum,swarm,"
             "swarm_floored,large_tiers,distributed,frontend,lidar,visual,"
             "deploy,gnc_sweep,scale,mac_calls, or mac_replay, small_svd_ab "
             "(not in the default run)")
    parser.add_argument(
        "--replay-roots", default=".",
        help="mac_replay, small_svd_ab: comma-separated trees whose "
             "cslam_tpu_torch replays the recorded selections or runs the "
             "SVD kernel")
    parser.add_argument("--replay-worker", nargs=2, metavar=("INPUTS", "OUT"),
                        help=argparse.SUPPRESS)
    parser.add_argument("--svd-ab-worker", nargs=2,
                        metavar=("INPUTS", "OUT"), help=argparse.SUPPRESS)
    args = parser.parse_args()
    phases = args.phases.split(",")
    _REPLAY_ROOTS[:] = args.replay_roots.split(",")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.replay_worker:      # before this checkout's package is imported
        return _replay_worker(*args.replay_worker, args.replay_roots)
    if args.svd_ab_worker:
        return _svd_ab_worker(*args.svd_ab_worker, args.replay_roots)
    try:
        from cslam_tpu_torch.ops import nns
    except ImportError as exc:
        print(f"chip_smoke: run from the repository root ({exc})",
              file=sys.stderr)
        return 2
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    libs = nns.build()
    print(f"built {', '.join(p.name for p in libs.values())} in "
          f"{time.perf_counter() - t0:.1f} s")
    for ptxas in sorted(nns.BUILD_DIR.glob("*.ptxas.txt")):
        print(ptxas.read_text().strip())

    results, failures = {}, []
    for phase in phases:
        print(f"phase {phase}")
        t_phase = time.perf_counter()
        try:
            _wait_prefetches()
            {"bank_scan": phase_bank_scan, "frontend": phase_frontend,
             "segment_sum": phase_segment_sum,
             "swarm": phase_swarm, "swarm_floored": phase_swarm_floored,
             "large_tiers": phase_large_tiers,
             "distributed": phase_distributed,
             "lidar": phase_lidar,
             "visual": phase_visual,
             "deploy": phase_deploy,
             "gnc_sweep": phase_gnc_sweep,
             "scale": phase_scale,
             "mac_calls": phase_mac_calls,
             "mac_replay": phase_mac_replay,
             "small_svd_ab": phase_small_svd_ab}[phase](results, failures)
        except Exception as exc:  # noqa: BLE001 - report, then fail the run
            import traceback
            traceback.print_exc()
            failures.append(f"{phase}: {type(exc).__name__}: {exc}")
        print(f"phase {phase}: {time.perf_counter() - t_phase:.1f} s")
    _wait_prefetches()              # no capture left running at exit

    card = _card_line()
    print(card)
    f32 = results.get("bank_scan", {}).get("float32", {})
    bf16 = results.get("bank_scan", {}).get("bfloat16", {})
    front = results.get("frontend", {})
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    lidar = results.get("lidar", {})
    search = lidar.get("sc_search", {})
    lidar_launches = (search.get("launches", {}).get("fused", 0)
                      + lidar.get("mission", {}).get("k1_launches", 0))
    visual = results.get("visual", {})
    visual_launches = (
        visual.get("visual_mission", {}).get("k1_launches", 0)
        + visual.get("visual_stereo", {}).get("mission", {}).get(
            "k1_launches", 0))
    deploy = results.get("deploy", {})
    deploy_launches = sum(
        deploy.get(part, {}).get("k1_launches", 0)
        for part in ("stereo_replay", "lidar_replay", "swarm_processes"))
    scale = results.get("scale", {})
    scale_launches = scale.get("k1_launches", 0)
    scale_small = scale.get("small_linalg_launches", {})
    dist = results.get("distributed", {})
    mesh = dist.get("mesh_banks", {})
    distributed_launches = (
        mesh.get("launches", 0)
        + dist.get("swarm_distributed", {}).get("k1_launches", 0)
        + dist.get("process_group", {}).get("k1_launches", 0))
    kernel = {
        "name": "bank_scan", "route": "cuda",
        "source": "cslam_tpu_torch/csrc/bank_scan.cu",
        "replaces": "cslam_tpu/ops/nns_pallas.py:177",
        "launches": results.get("swarm", {}).get(
            "launches", f32.get("launches_main_path", 0)) + lidar_launches
        + visual_launches + deploy_launches + distributed_launches
        + scale_launches,
        "launches_lidar": lidar_launches,
        "launches_scale": scale_launches,
        "launches_visual": visual_launches,
        "launches_deploy": deploy_launches,
        "launches_distributed": distributed_launches,
        "max_abs_err": max([c.get("max_abs_err", 0.0) for c in
                            f32.get("cases", []) + bf16.get("cases", [])]
                           + [search.get(f"k1_b{b}", {}).get(
                               "max_abs_err", 0.0) for b in (1, 16)]
                           + [f32.get("max_abs_err", 0.0),
                              bf16.get("max_abs_err", 0.0),
                              mesh.get("max_abs_err", 0.0)]),
        **{key: f32.get(key) for key in keys},
        "ms_l2_flushed": f32.get("ms_l2_flushed"),
        "library_ms_l2_flushed": f32.get("library_ms_l2_flushed"),
        "bound_fp32_ms": f32.get("bound_fp32_ms"),
        "kernels_per_call": front.get("bank_scan_b512_profile", {}).get(
            "kernels_per_call"),
        "variants": {"bfloat16": {key: v for key, v in bf16.items()
                                  if key != "cases"},
                     "lidar_ring_keys_65536x32_B16": search.get("b16"),
                     "lidar_ring_keys_65536x32_B1": search.get("b1"),
                     "mesh_banks_8x131072x64_B256": mesh or None}}
    b1 = front.get("tile_scan_b1", {})   # the frontend step's shape
    tile = {
        "name": "tile_scan", "route": "cuda",
        "source": "cslam_tpu_torch/csrc/tile_scan.cu",
        "replaces": "cslam_tpu/ops/nns_pallas.py:34",
        "launches": front.get("launches_main_path", {}).get("tile_scan", 0),
        "max_abs_err": front.get("tile_scan_max_abs_err"),
        **{key: b1.get(key) for key in keys},
        "bound_fp32_ms": b1.get("bound_fp32_ms"),
        "kernels_per_call": b1.get("profile", {}).get("kernels_per_call"),
        "device_ms": b1.get("profile", {}).get("device_ms"),
        "library_device_ms": b1.get("library_profile", {}).get("device_ms"),
        "variants": {"B512_k10": front.get("tile_scan_b512")}}
    lt = results.get("large_tiers", {})
    sml = lt.get("small_linalg", {})
    times = sml.get("times_ms", {})
    missions = [results.get(ph, {}).get("mac", {})
                for ph in ("swarm", "swarm_floored")]

    def runs(kind):
        return sum(m.get("small_linalg_launches", {}).get(kind, 0)
                   for m in missions) + scale_small.get(kind, 0)
    # null where the checkout has no mirror (nothing was held against it)
    mirror_errs = [e for e in (sml.get(k, {}).get("mirror_max_abs_err")
                               for k in ("rayleigh_ritz", "svqb", "random"))
                   if e is not None]
    small_eigh = {
        "name": "small_eigh", "route": "cuda",
        "source": "cslam_tpu_torch/csrc/small_eigh.cu",
        "replaces": "no TPU kernel: torch.linalg.eigh in LOBPCG "
                    "(cslam_tpu_torch/ops/lobpcg.py; the JAX package's "
                    "lobpcg_standard at cslam_tpu/ops/fiedler.py:230)",
        "launches": runs("eigh"),
        "max_abs_err": max([sml.get(k, {}).get("max_abs_err", 0.0)
                            for k in ("rayleigh_ritz", "svqb", "random")]),
        "max_abs_err_jacobi_ref": max(mirror_errs) if mirror_errs else None,
        "ms": times.get("eigh12"), "plain_ms": times.get("eigh12_plain"),
        "bound_ms": sml.get("eigh12_bound", {}).get("bound_ms"),
        "bound_by": sml.get("eigh12_bound", {}).get("bound_by"),
        "library_ms": times.get("eigh12_library"),
        "shape": "12 x 12, batch 1 (Rayleigh-Ritz at block 4), sweeps of "
                 "11 parallel steps",
        "kernel_work": sml.get("eigh12_kernel_work"),
        "variants": {"4x4": {
            "ms": times.get("eigh4"), "plain_ms": times.get("eigh4_plain"),
            "library_ms": times.get("eigh4_library"),
            "bound_ms": sml.get("eigh4_bound", {}).get("bound_ms"),
            "bound_by": sml.get("eigh4_bound", {}).get("bound_by"),
            "kernel_work": sml.get("eigh4_kernel_work")}},
        "checks": {k: sml.get(k) for k in ("rayleigh_ritz", "svqb",
                                           "random")}}
    small_svd = {
        "name": "small_svd", "route": "cuda",
        "source": "cslam_tpu_torch/csrc/small_eigh.cu",
        "replaces": "no TPU kernel: torch.linalg.svd in LOBPCG's basis "
                    "extension (cslam_tpu_torch/ops/lobpcg.py)",
        "launches": runs("svd"),
        "max_abs_err": sml.get("svd", {}).get("max_abs_err"),
        "ms": times.get("svd4"), "plain_ms": times.get("svd4_plain"),
        "bound_ms": sml.get("svd4_bound", {}).get("bound_ms"),
        "bound_by": sml.get("svd4_bound", {}).get("bound_by"),
        "library_ms": times.get("svd4_library"),
        "device_ms": sml.get("device_ms", {}).get("svd4"),
        "device_ms_batch1024": sml.get("device_ms", {}).get(
            "svd4_batch1024"),
        "mirror_mismatches": sml.get("svd", {}).get("mirror_mismatches"),
        "sweeps": sml.get("svd", {}).get("sweeps"),
        "shape": "4 x 4, batch 1 (a block of the selection), sweeps of 3 "
                 "parallel steps",
        "checks": sml.get("svd")}
    stages = results.get("mac_calls", {}).get("stages", [])
    stage = max(stages, key=lambda r: r["P"], default={})
    graph_while = {
        "name": "graph_while", "route": "cuda",
        "source": "cslam_tpu_torch/csrc/graph_while.cu",
        "replaces": "no TPU kernel: the lax.while_loop of each LOBPCG "
                    "stage (cslam_tpu/ops/fiedler.py:230-245) and the "
                    "distributed solve's nested sweep, LM and CG loops "
                    "(cslam_tpu/pgo/distributed.py:644-761)",
        "launches": sum(m.get("programs", {}).get("mac_woodbury", {}).get(
            "lobpcg", {}).get("replays", 0) for m in missions)
        + scale.get("while_launches", 0) + dist.get("while_launches", 0),
        "launches_distributed": dist.get("while_launches", 0),
        "max_abs_err": stage.get("max_abs_err"), "ms": stage.get("ms"),
        "plain_ms": stage.get("plain_ms"), "bound_ms": stage.get("bound_ms"),
        "bound_by": stage.get("bound_by"), "library_ms": None,
        "shape": f"one LOBPCG stage at P = {stage.get('P')}, "
                 f"{stage.get('iterations')} iterations (graphed, eager)",
        "variants": {f"P{r['P']}_E{r['E']}": {
            "ms": r.get("ms"), "bound_ms": r.get("bound_ms"),
            "body_trsm_ms": r.get("body_trsm_ms"),
            "ms_before": (r.get("before") or {}).get("ms"),
            "bound_before_ms": r.get("bound_ref_ms"),
            "apply_max_err_in_eps": max(
                a["err_in_eps_of_max_tinv_x"]
                for a in r.get("apply", {}).values())
            if r.get("apply") else None} for r in stages}}
    sums = results.get("segment_sum", {}).get("cases", {})
    main_case = sums.get("pgo_8x1024_pcg_matvec_6", {})
    # the distributed solves on the main path are the graphed ones
    # (cold_first, cold, warm); the plain and in-turn routes are
    # comparisons, counted apart
    dist_runs = [run for part in ("pgo_8x512", "pgo_8x1024_pcg")
                 for run in dist.get(part, {}).values()
                 if isinstance(run, dict) and "segment_sum_launches" in run]
    sum_runs = {
        "swarm": results.get("swarm", {}).get("pgo", {}).get(
            "segment_sum_launches"),
        "swarm_floored": results.get("swarm_floored", {}).get(
            "segment_sum_launches"),
        "distributed": sum((run["segment_sum_launches"] or 0)
                           for run in dist_runs if run["route"] == "steps"),
        "scale": scale.get("segment_sum_launches")}
    segment = {
        "name": "segment_sum", "route": "cuda",
        "source": "cslam_tpu_torch/csrc/segment_sum.cu",
        "replaces": "no TPU kernel: the port's atomic index_add_ / "
                    "index_put_(accumulate=True) normal-equation sums (the "
                    "JAX package's one-hot matmuls, cslam_tpu/pgo/"
                    "solver.py:154-195, cslam_tpu/pgo/distributed.py:"
                    "380-400)",
        "launches": sum(v or 0 for v in sum_runs.values()),
        "launches_by_run": sum_runs,
        "launches_off_path": {
            route: sum((run["segment_sum_launches"] or 0)
                       for run in dist_runs if run["route"] == route)
            for route in ("host", "in_turn")},
        "max_abs_err": max([c.get("max_abs_err", 0.0)
                            for c in sums.values()] or [None]),
        **{key: main_case.get(key) for key in keys},
        "shape": "pgo_8x1024_pcg's CG matvec: 8 x 1,024 nodes, rows of 6",
        "variants": {name: {k: c.get(k) for k in
                            ("ms", "plain_ms", "library_ms", "bound_ms",
                             "bound_by", "bound_with_plan_ms", "bit_for_bit",
                             "atomic_repeats")}
                     for name, c in sums.items()}}
    print(json.dumps({"kernels": [kernel, tile, small_eigh, small_svd,
                                  graph_while, segment]}))
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
