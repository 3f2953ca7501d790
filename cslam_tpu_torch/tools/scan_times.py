"""Times the bank scans K1 (``nns.cosine_topk_scan``) and K2
(``nns.cosine_topk_fused``) of whichever ``cslam_tpu_torch`` comes first on
``sys.path``, at the shapes ``chip_smoke.py`` reports, and prints one JSON
line. Two checkouts are compared on one card in one command, alternating
(the first, the second, the second, the first):

    for d in old new new old; do
        PYTHONPATH=$d python3 cslam_tpu_torch/tools/scan_times.py --label $d
    done

Only the public wrappers are called, so any checkout since the first port
slice can be timed. CUDA-event times, the mean of 20 calls after 2 warm-up
calls; "flushed" writes 256 MB (more than the 50 MB L2) before each call.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

N, N_VALID, D = 131072, 100000, 64


def _timed(fn, flush=None, iters=20):
    for _ in range(2):
        fn()
    pairs = []
    for _ in range(iters):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        pairs.append((start, stop))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default="")
    args = parser.parse_args()
    from cslam_tpu_torch.ops import nns
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((N_VALID, D)).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, (N_VALID, 1)).astype(np.float32)
    queries = torch.from_numpy(
        rng.standard_normal((512, D)).astype(np.float32)).cuda()
    unit = torch.zeros((N, D), device="cuda")
    unit[:N_VALID] = torch.from_numpy(
        rows / np.linalg.norm(rows, axis=1, keepdims=True)).cuda()
    raw = torch.zeros((N, D), device="cuda")
    raw[:N_VALID] = torch.from_numpy(rows * scale).cuda()
    inv = torch.zeros(N, device="cuda")
    inv[:N_VALID] = 1.0 / raw[:N_VALID].norm(dim=1)
    flush = torch.empty(64 * 2 ** 20, device="cuda").zero_
    out = {"label": args.label, "package": nns.__file__}
    for dtype in (torch.float32, torch.bfloat16):
        bank = unit.to(dtype)
        name = str(dtype).split(".")[-1]
        for B in (512, 8):
            q = queries[:B]

            def k1():
                return nns.cosine_topk_scan(bank, N_VALID, q, 10)
            out[f"k1_{name}_b{B}_ms"] = _timed(k1)
            out[f"k1_{name}_b{B}_ms_flushed"] = _timed(k1, flush)
    for B, k in ((1, 8), (512, 10)):
        q = queries[:B]
        out[f"k2_float32_b{B}_ms_flushed"] = _timed(
            lambda: nns.cosine_topk_fused(raw, inv, N_VALID, q, k), flush)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
