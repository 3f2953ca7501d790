#!/usr/bin/env python3
"""Replay KITTI-odometry-format sequences through the port's full pipeline.

The port's twin of ``examples/kitti_replay.py``. Each robot replays one
sequence directory (or a frame range of a shared one); stereo frames feed
``StereoFrontEnd`` -> ``DetectionFrontEnd`` -> ``DecentralizedPGO`` on the
CUDA device, and ATE is reported against the dataset's ground truth.
Without a VPR checkpoint the tiny-image descriptor is used; pass
``--checkpoint`` to run CosPlace. With ``--lidar`` the sequence's
``velodyne/*.bin`` scans drive the lidar pipeline instead (PointCloud2
decode -> ``LidarFrontEnd`` -> scan-context matching -> robust ICP -> PGO).

    python3 cslam_tpu_torch/tools/kitti_replay.py \\
        /path/to/sequences/00 /path/to/sequences/01
    python3 cslam_tpu_torch/tools/kitti_replay.py --split 2 \\
        /path/to/sequences/00        # one sequence, 2 virtual robots
    python3 cslam_tpu_torch/tools/kitti_replay.py --lidar \\
        /path/to/sequences/00 /path/to/sequences/01

Runs on the CUDA device and raises without one; ``--cpu`` asks for the CPU.
"""
from __future__ import annotations

import argparse
import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from cslam_tpu_torch.runtime.replay import (KittiSequence,  # noqa: E402
                                            LidarReplayDriver, ReplayDriver,
                                            TinyImageDescriptor)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sequences", nargs="+",
                    help="KITTI sequence directories (one per robot)")
    ap.add_argument("--split", type=int, default=0,
                    help="split ONE sequence into N virtual robots")
    ap.add_argument("--checkpoint", default="",
                    help="CosPlace .pth; default = tiny-image descriptor")
    ap.add_argument("--odom-noise", type=float, default=0.02)
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--lidar", action="store_true",
                    help="replay velodyne/*.bin scans through the lidar "
                         "pipeline (scan-context, no VPR model)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA device")
    args = ap.parse_args()

    def nb_frames(seq):
        # lidar mode indexes the scan list; image counts can differ
        return seq.nb_scans if args.lidar else len(seq)

    if args.split > 1:
        assert len(args.sequences) == 1
        seq = KittiSequence(args.sequences[0])
        n = nb_frames(seq) if not args.max_frames else min(
            nb_frames(seq), args.max_frames)
        per = n // args.split
        sequences = [seq] * args.split
        ranges = [range(i * per, (i + 1) * per) for i in range(args.split)]
    else:
        sequences = [KittiSequence(p) for p in args.sequences]
        ranges = None
        if args.max_frames:
            ranges = [range(min(nb_frames(s), args.max_frames))
                      for s in sequences]

    device = "cpu" if args.cpu else None
    if args.lidar:
        driver = LidarReplayDriver(sequences, frame_ranges=ranges,
                                   odom_noise=args.odom_noise, device=device)
    else:
        model = TinyImageDescriptor()
        if args.checkpoint:
            from cslam_tpu_torch.models.cosplace import CosPlace
            model = CosPlace({"frontend.nn_checkpoint": args.checkpoint,
                              "frontend.cosplace.descriptor_dim": 64,
                              "frontend.cosplace.backbone": "resnet18",
                              "frontend.image_crop_size": 376,
                              "robot_id": 0}, device=device)
        driver = ReplayDriver(sequences, frame_ranges=ranges,
                              odom_noise=args.odom_noise, model=model,
                              device=device)
    driver.run()

    for rid, robot in enumerate(driver.robots):
        inter = sum(len(v) for v in
                    robot.backend.inter_robot_loop_closures.values())
        ate_odo, ate_opt = driver.ate(rid)
        print(f"r{rid}: keyframes={robot.frontend.nb_local_keyframes} "
              f"inter_lc={inter} "
              f"optimizations={robot.backend.optimization_count} "
              f"ATE odom={ate_odo:.3f} m -> optimized={ate_opt:.3f} m")


if __name__ == "__main__":
    main()
