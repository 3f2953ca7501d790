#!/usr/bin/env python3
"""Geometric-verification throughput: per-pair calls against one batch.

The port's twin of ``benchmarks/verification_bench.py``. The reference
verifies loop-closure candidates one RANSAC-PnP call at a time
(rgbd_handler.cpp:493-554); ``gnc_align_batch`` verifies a whole
candidate batch in one call. Each trial draws fresh values: P = 16 rigid
problems with 20% outliers, padded to ``MAX_CORRESPONDENCES``, timed

- ``batched``: one ``gnc_align_batch`` (on the card a replay of the
  tier's CUDA graph), then one read of the inlier counts;
- ``batched_eager``: the same chunk through ``_gnc_align_core`` launched
  op by op;
- ``sequential``: ``gnc_align`` per pair, each followed by a read of its
  inlier count (the honest sequential pattern);
- ``sequential_graphed``: ``gnc_align_batch`` of one pair per call (the
  P = 1 graph), each followed by a read.

    python3 cslam_tpu_torch/tools/verification_bench.py          # card
    python3 cslam_tpu_torch/tools/verification_bench.py --device cpu

Prints the card's ``nvidia-smi`` name and power limit on the card, then
one JSON line with each mode's times (ms, host clock around work that
ends in a read) per trial and their medians.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cslam_tpu_torch import resolve_device  # noqa: E402
from cslam_tpu_torch.ops import highest_precision  # noqa: E402
from cslam_tpu_torch.ops import visual_registration as vreg  # noqa: E402
from cslam_tpu_torch.tools.harness import card_line  # noqa: E402

P = 16           # candidate pairs per round (a busy detection period)
INLIER_DIST = 0.3


def make_batch(rng):
    """P random rigid problems with 20% outliers, padded to MAX_CORR."""
    src = np.zeros((P, vreg.MAX_CORRESPONDENCES, 3), np.float32)
    dst = np.zeros((P, vreg.MAX_CORRESPONDENCES, 3), np.float32)
    valid = np.zeros((P, vreg.MAX_CORRESPONDENCES), np.float32)
    n = 200
    for i in range(P):
        pts = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
        angle = rng.uniform(-0.5, 0.5)
        c, s = np.cos(angle), np.sin(angle)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        t = rng.uniform(-1, 1, 3).astype(np.float32)
        moved = pts @ R.T + t
        moved[:: 5] += rng.uniform(2, 5, (len(moved[::5]), 3))
        src[i, :n], dst[i, :n], valid[i, :n] = pts, moved, 1.0
    return src, dst, valid


def _modes(device):
    """{mode: fn(src, dst, valid) -> inlier counts read to the host}."""
    eager_core = highest_precision(vreg._gnc_align_core)

    def batched(s, d, v):
        return vreg.gnc_align_batch(s, d, v, INLIER_DIST,
                                    device=device)[1].cpu()

    def batched_eager(s, d, v):
        ts = [torch.as_tensor(x, device=device) for x in (s, d, v)]
        dist = torch.tensor(INLIER_DIST, dtype=torch.float32, device=device)
        return eager_core(*ts, dist, 12)[1].cpu()

    def sequential(s, d, v):
        return [int(vreg.gnc_align(s[i], d[i], v[i], INLIER_DIST,
                                   device=device)[1]) for i in range(P)]

    def sequential_graphed(s, d, v):
        return [int(vreg.gnc_align_batch(s[i:i + 1], d[i:i + 1], v[i:i + 1],
                                         INLIER_DIST, device=device)[1][0])
                for i in range(P)]
    return {"batched": batched, "batched_eager": batched_eager,
            "sequential": sequential,
            "sequential_graphed": sequential_graphed}


def run(device=None, trials: int = 5, seed: int = 0) -> dict:
    """Each mode twice with fresh values (the warmup: the graphs' captures,
    the libraries' handles), then ``trials`` timed runs of each, every one
    on fresh values. Returns ms per trial and medians per mode, and
    whether the modes counted the same inliers on one chunk."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    modes = _modes(device)
    for fn in modes.values():
        for _ in range(2):
            fn(*make_batch(rng))
    s, d, v = make_batch(rng)
    counts = {m: [int(x) for x in fn(s, d, v)] for m, fn in modes.items()}
    times = {m: [] for m in modes}
    for _ in range(trials):
        for m, fn in modes.items():
            batch = make_batch(rng)
            t0 = time.perf_counter()
            fn(*batch)
            times[m].append((time.perf_counter() - t0) * 1e3)
    med = {m: float(np.median(t)) for m, t in times.items()}
    return {"metric": "verification_pairs_per_sec_batched",
            "value": P / (med["batched"] / 1e3), "unit": "pairs/sec",
            "pairs": P, "device": device.type, "trials": trials,
            "ms": times, "median_ms": med,
            "speedup_vs_sequential": med["sequential"] / med["batched"],
            "same_inliers": len({tuple(c) for c in counts.values()}) == 1,
            "inliers": counts["batched"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--trials", type=int, default=5)
    args = ap.parse_args()
    device = resolve_device(args.device)
    if device.type == "cuda":
        print(card_line(), flush=True)
    print(json.dumps(run(device, args.trials)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
