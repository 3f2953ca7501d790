"""The port's scale tools (``cslam_tpu_torch/tools/{lidar,visual}_e2e_scale``)
carry the JAX benches' per-robot pins, run a small mission on the CPU with
every key of their report, and serve ``chip_smoke.py``'s missions."""
import importlib.util
import math
import pathlib

import pytest

from cslam_tpu_torch.tools import lidar_e2e_scale, visual_e2e_scale
from torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent

#: ``benchmarks/lidar_e2e_scale_bench.py:122-170``
LIDAR_PINS = {
    "frontend.sensor_type": "lidar",
    "frontend.global_descriptor_technique": "scancontext",
    "frontend.similarity_threshold": 0.7,
    "frontend.keyframe_generation_ratio_distance": 0.5,
    "frontend.voxel_size": 0.4,
    "frontend.registration_min_inliers": 40,
    "frontend.inter_robot_detection_period_sec": 3.0,
    "frontend.detection_publication_period_sec": 1.0,
    "frontend.mac_mf_floor": 2048,
    "frontend.mac_p_floor": 2048,
    "frontend.mac_e_floor": 2048,
    "frontend.max_candidate_pool": 2048,
    "frontend.harvest_ready_gate": True,
    "backend.pose_graph_optimization_start_period_ms": 30000,
    "backend.pgo_np_floor": 2048,
    "backend.pgo_ne_floor": 2048,
    "neighbor_management.enable_neighbor_monitoring": False,
}
#: ``benchmarks/visual_e2e_scale_bench.py:134-160``
VISUAL_PINS = {
    **{k: v for k, v in LIDAR_PINS.items() if k not in (
        "frontend.sensor_type", "frontend.global_descriptor_technique",
        "frontend.similarity_threshold", "frontend.voxel_size",
        "frontend.keyframe_generation_ratio_distance",
        "frontend.registration_min_inliers")},
    "frontend.sensor_type": "rgbd",
    "frontend.global_descriptor_technique": "cosplace",
    "frontend.nn_checkpoint": "random",
    "frontend.image_crop_size": 224,
    "frontend.similarity_threshold": 0.998,
    "frontend.keyframe_generation_ratio_threshold": 1.0,
    "frontend.pnp_min_inliers": 10,
    "frontend.warmup_verification_tiers": (1, 2, 4, 8, 16),
}
#: ``--sync`` in both benches
SYNC = {"frontend.async_detection": False,
        "frontend.async_verification": False}

REPORT_KEYS = {
    "robots", "steps", "scenes", "device", "pins", "sync", "drain_steps",
    "warmup_s", "total_keyframes", "steady_wall_clock_s", "keyframes_per_s",
    "sim_seconds", "real_time_factor", "inter_robot_loops", "optimizations",
    "ate_odometry_m", "ate_optimized_m", "captures_after_warmup", "graphs",
    "verify_pairs", "icp_gate_pass", "icp_gate_pass_rate", "k1_launches",
    "small_linalg_launches", "while_launches", "mac_fw_dispatch_s",
    "pgo_optimize_s", "spans", "nodes"}


@pytest.mark.parametrize("tool,pins", [(lidar_e2e_scale, LIDAR_PINS),
                                       (visual_e2e_scale, VISUAL_PINS)])
def test_configs_carry_the_bench_pins(tool, pins):
    params = tool.robot_config(1, 5)
    assert {k: params[k] for k in pins} == pins
    assert params["robot_id"] == 1 and params["max_nb_robots"] == 5
    synced = tool.robot_config(0, 5, sync=True)
    assert {k: synced[k] for k in SYNC} == SYNC
    unpinned = tool.robot_config(0, 5, pins=False)
    assert unpinned["frontend.mac_p_floor"] != 2048
    assert unpinned["backend.pgo_np_floor"] != 2048


def test_lidar_tool_adds_the_fused_stage1():
    params = lidar_e2e_scale.robot_config(0, 5)
    assert params["frontend.scancontext_fused_stage1"] is True
    assert params["frontend.bank_initial_capacity"] == 4096


def _check_report(out, robots, steps):
    assert REPORT_KEYS <= set(out)
    assert out["device"] == "cpu" and out["sync"] and not out["pins"]
    assert out["total_keyframes"] == robots * steps
    assert out["sim_seconds"] == steps + out["drain_steps"]
    assert out["captures_after_warmup"] == 0
    assert math.isfinite(out["ate_odometry_m"])
    assert out["verify_pairs"] >= out["icp_gate_pass"] >= 0
    assert "pgo.optimize" in out["spans"]
    assert len(out["nodes"]) == robots


def test_lidar_mission_reports_every_key(tmp_path):
    out = lidar_e2e_scale.run_mission(2, 6, device="cpu", pins=False,
                                      sync=True, warmup=False, drain=35,
                                      dump_dir=tmp_path, log=lambda s: None)
    _check_report(out, 2, 6)
    assert {"points"} <= set(out)
    assert out["optimizations"] >= 1
    assert sorted(p.name for p in tmp_path.iterdir())[0] == "pgo_r0_000.npz"


def test_visual_mission_reports_every_key():
    out = visual_e2e_scale.run_mission(2, 6, device="cpu", pins=False,
                                       sync=True, warmup=False, drain=35,
                                       log=lambda s: None)
    _check_report(out, 2, 6)
    assert out["native_available"] is True
    assert out["front_end"] == "RGBDFrontEnd"


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _fake_report(**extra):
    return {"inter_robot_loops": 3, "ate_odometry_m": 0.5,
            "ate_optimized_m": 0.2, "k1_launches": 7,
            "captures_after_warmup": 0, "spans": {},
            "graphs": {"by_set": {
                name: {"captures": 0, "captures_bg": 0, "replays": 5}
                for name in ("registration._verify_pair_batch",
                             "visual_registration.gnc_align_batch",
                             "visual_registration.gnc_pnp_batch")}},
            "nodes": [], **extra}


@pytest.mark.parametrize("part,tool,args", [
    ("_lidar_mission", lidar_e2e_scale, (3, 40, 40, 4096, "cuda")),
    ("_visual_mission", visual_e2e_scale, (3, 40, 40, "cuda"))])
def test_chip_smoke_missions_call_the_tools(chip_smoke, monkeypatch, part,
                                            tool, args):
    calls = []

    def fake(*a, **kw):
        calls.append((a, kw))
        return _fake_report(native_available=True)
    monkeypatch.setattr(tool, "run_mission", fake)
    failures = []
    out = getattr(chip_smoke, part)(failures)
    assert [c[0] for c in calls] == [args]
    assert calls[0][1]["pins"] is False
    assert out["cuts"]["steps"] == "40 (bench 210)"
    assert "nodes" not in out
    # the fake writes no dump and captures no verification graph
    assert all("graphs after the warmup" in f or "no PGO dump written" in f
               for f in failures)
    bad = []
    monkeypatch.setattr(tool, "run_mission", lambda *a, **kw: _fake_report(
        native_available=True, captures_after_warmup=2, inter_robot_loops=0))
    getattr(chip_smoke, part)(bad)
    assert any("no verified inter-robot loop" in f for f in bad)
    assert any("2 graph captures after the warmup" in f for f in bad)
