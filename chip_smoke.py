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
* phase ``swarm`` — the port's ``SwarmSimulator`` on CUDA with 4 robots x
  120 keyframes (480 poses, the largest swarm on the dense MAC and PGO
  tiers), plus a two-robot run on CUDA held against the same run on the CPU
  (the plain versions);
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
  every timing).

Every kernel's launch counter is set to 0 just before each main-path run and
read just after; a kernel that did not launch fails the run. Prints the
card's ``name, power.limit``, then one ``{"kernels": [...]}`` line, then, as
the last line, ``{"ok": true, "device": {...}}``. Any failure exits non-zero
without the last line. Imports only the port, never JAX.
"""
from __future__ import annotations

import argparse
import json
import struct
import subprocess
import sys
import time

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
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def _bound(flops: float, nbytes: float, dtype: str) -> dict:
    """The least time the card could take for ``flops`` on the tensor cores
    (the screen's input type) and ``nbytes`` of memory traffic, and the same
    on the FP32 cores (the rate the exact rescore runs at)."""
    t_flops, t_bytes = flops / _PEAK_FLOPS[dtype], nbytes / _PEAK_BYTES
    return {"bound_ms": max(t_flops, t_bytes) * 1e3,
            "bound_by": "operations" if t_flops >= t_bytes else "bytes",
            "bound_fp32_ms": max(flops / _PEAK_FP32, t_bytes) * 1e3,
            "flops": flops, "bytes": nbytes}


def _device_profile(fn, iters: int = 20) -> dict:
    """Per call: the host wall time, the device time of every CUDA kernel
    ``fn`` launches, of the bank scans' scan kernels (``screen_kernel``,
    ``small_kernel``) and merge kernel (``torch.profiler``), the number of
    CUDA kernels, and the device's idle share of the wall; device times are
    ``None`` where the profiler saw none. Run it after every timing: its
    tracing may slow what runs after it."""
    import warnings

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / iters
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]

    def ms(pick):
        return sum(e.device_time_total for e in kernels
                   if pick(e.key)) / 1e3 / iters
    device_ms = ms(lambda key: True)
    if device_ms <= 0:
        return {"wall_ms": wall_ms, "device_ms": None, "idle_share": None,
                "kernels_per_call": None}
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "scan_kernel_ms": ms(lambda key: "screen_kernel" in key
                                 or "small_kernel" in key),
            "merge_kernel_ms": ms(lambda key: "merge_kernel" in key),
            "kernels_per_call": sum(e.count for e in kernels) / iters,
            "idle_share": max(0.0, 1.0 - device_ms / wall_ms)}


def _compare(name, got, ref, failures, tol=0.0) -> float:
    """Exact indices; finite values within ``tol`` (a kernel against its
    plain version: 0, bit for bit); -inf where -inf."""
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
    torch.cuda.synchronize()
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
        torch.cuda.synchronize()
        nns.tile_scan_launches = nns.launches = 0
        desc, sims, idx = frontend_step(net, images, bank, inv, n, 8)
        torch.cuda.synchronize()
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
        torch.cuda.synchronize()
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
    parser.add_argument("--phases", default="bank_scan,swarm,frontend",
                        help="comma-separated subset of "
                             "bank_scan,swarm,frontend")
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
    libs = nns.build()
    print(f"built {', '.join(p.name for p in libs.values())} in "
          f"{time.perf_counter() - t0:.1f} s")
    for ptxas in sorted(nns.BUILD_DIR.glob("*.ptxas.txt")):
        print(ptxas.read_text().strip())

    results, failures = {}, []
    for phase in phases:
        print(f"phase {phase}")
        try:
            {"bank_scan": phase_bank_scan, "frontend": phase_frontend,
             "swarm": phase_swarm}[phase](results, failures)
        except Exception as exc:  # noqa: BLE001 - report, then fail the run
            import traceback
            traceback.print_exc()
            failures.append(f"{phase}: {type(exc).__name__}: {exc}")

    card = _card_line()
    print(card)
    f32 = results.get("bank_scan", {}).get("float32", {})
    bf16 = results.get("bank_scan", {}).get("bfloat16", {})
    front = results.get("frontend", {})
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernel = {
        "name": "bank_scan", "route": "cuda",
        "source": "cslam_tpu_torch/csrc/bank_scan.cu",
        "replaces": "cslam_tpu/ops/nns_pallas.py:177",
        "launches": results.get("swarm", {}).get(
            "launches", f32.get("launches_main_path", 0)),
        "max_abs_err": max([c.get("max_abs_err", 0.0) for c in
                            f32.get("cases", []) + bf16.get("cases", [])]
                           + [f32.get("max_abs_err", 0.0),
                              bf16.get("max_abs_err", 0.0)]),
        **{key: f32.get(key) for key in keys},
        "ms_l2_flushed": f32.get("ms_l2_flushed"),
        "library_ms_l2_flushed": f32.get("library_ms_l2_flushed"),
        "bound_fp32_ms": f32.get("bound_fp32_ms"),
        "kernels_per_call": front.get("bank_scan_b512_profile", {}).get(
            "kernels_per_call"),
        "variants": {"bfloat16": {key: v for key, v in bf16.items()
                                  if key != "cases"}}}
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
    print(json.dumps({"kernels": [kernel, tile]}))
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
