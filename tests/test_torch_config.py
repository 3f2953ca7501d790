"""Config tree: dotted interop, YAML loading, the shipped example file.

The reference flattens ROS 2 parameters into plain dicts for the library
layer (``cslam/loop_closure_detection_node.py:20-95``) and documents them in
``config/cslam/README.md`` + ``example.yaml``; this covers our equivalent
surface (``cslam_tpu/config.py``, ``config/example.yaml``, docs/CONFIG.md).

The port's mirror of ``tests/test_config.py``: ``cslam_tpu_torch/config.py``
is the JAX package's module with the port's imports, so the same cases
hold it, port only.
"""
import os

import pytest

from cslam_tpu_torch.config import CslamConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_flatten_has_all_five_namespaces():
    flat = CslamConfig(robot_id=3, max_nb_robots=7).flatten()
    assert flat["robot_id"] == 3 and flat["max_nb_robots"] == 7
    for ns in ("frontend", "backend", "neighbor_management", "evaluation",
               "visualization"):
        assert any(k.startswith(ns + ".") for k in flat), ns
    # the reference's exact dotted spellings are exposed too
    assert flat["frontend.cosplace.descriptor_dim"] == \
        flat["frontend.cosplace_descriptor_dim"]


def test_set_dotted_coerces_and_aliases():
    cfg = CslamConfig()
    cfg.set_dotted("backend.max_waiting_time_sec", 30)   # int -> float
    assert cfg.backend.max_waiting_time_sec == 30.0
    cfg.set_dotted("frontend.cosplace.backbone", "vgg16")  # reference alias
    assert cfg.frontend.cosplace_backbone == "vgg16"
    # every documented TPU knob is a real field (set_dotted rejects typos)
    for key, val in (("frontend.mac_lobpcg_short_iters", 48),
                     ("frontend.mac_fw_warm_ritz", True),
                     ("frontend.nns_bank_dtype", "bfloat16"),
                     ("backend.pgo_mode", "distributed")):
        cfg.set_dotted(key, val)
    assert cfg.frontend.mac_fw_warm_ritz is True


def test_unknown_key_fails_fast():
    with pytest.raises(KeyError):
        CslamConfig().set_dotted("frontend.similarity_treshold", 0.5)


def test_shipped_example_yaml_loads():
    cfg = CslamConfig.from_yaml(os.path.join(REPO, "config", "example.yaml"))
    assert cfg.max_nb_robots == 5
    assert cfg.frontend.enable_intra_robot_loop_closures is True
    assert cfg.frontend.intra_loop_min_inbetween_keyframes == 20
    assert cfg.frontend.cosplace_descriptor_dim == 64
    assert cfg.neighbor_management.enable_neighbor_monitoring is True
    assert cfg.backend.pgo_mode == "centralized"
    flat = cfg.flatten()
    assert flat["frontend.global_descriptor_technique"] == "cosplace"


def test_plain_nested_yaml_without_ros_wrapper(tmp_path):
    p = tmp_path / "c.yaml"
    p.write_text("robot_id: 2\nfrontend:\n  similarity_threshold: 0.8\n")
    cfg = CslamConfig.from_yaml(str(p))
    assert cfg.robot_id == 2
    assert cfg.frontend.similarity_threshold == 0.8
