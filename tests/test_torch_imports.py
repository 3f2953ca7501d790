"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points refuse to fall back to the CPU when no GPU is there."""
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
_FORBIDDEN = re.compile(
    r"^\s*(import jax|from jax|import cslam_tpu\b(?!_)|from cslam_tpu[ .])",
    re.MULTILINE)


def test_package_imports_without_jax():
    """Every port module imports in a fresh interpreter where ``jax`` and
    ``cslam_tpu`` cannot be imported at all."""
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['cslam_tpu'] = None\n"
        "import cslam_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    cslam_tpu_torch.__path__, 'cslam_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30


def test_vpr_models_entry_and_kernels_import_without_jax():
    """The second slice's modules by name: the VPR models, the entry twin
    and the kernels' wrappers."""
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['cslam_tpu'] = None\n"
        "for name in ('models', 'models.preprocess', 'models.backbones',\n"
        "             'models.golden', 'models.convert', 'models.cosplace',\n"
        "             'models.pca', 'models.netvlad', 'entry', 'convert',\n"
        "             'ops.nns', 'ops.small_linalg', 'ops.segment_sum'):\n"
        "    importlib.import_module('cslam_tpu_torch.' + name)\n"
        "from cslam_tpu_torch.ops import nns\n"
        "print(nns.KERNEL_K, sorted(nns.SOURCES))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["10", "['bank_scan',", "'graph_while',",
                                  "'segment_sum',", "'small_eigh',",
                                  "'tile_scan']"]


def test_lidar_modules_import_without_jax():
    """The lidar slice's modules by name: scan context ops, model and bank,
    registration, the GNC core, the lidar front end, the host-only copies."""
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['cslam_tpu'] = None\n"
        "for name in ('ops.scancontext', 'models.scancontext',\n"
        "             'matching.scancontext_bank', 'ops.registration',\n"
        "             'ops.visual_registration', 'runtime.lidar_frontend',\n"
        "             'utils.compression', 'utils.point_cloud2'):\n"
        "    importlib.import_module('cslam_tpu_torch.' + name)\n"
        "from cslam_tpu_torch.runtime import LidarFrontEnd\n"
        "from cslam_tpu_torch.ops import topk\n"
        "print(LidarFrontEnd.__name__, topk.euclidean_topk.__name__)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["LidarFrontEnd", "euclidean_topk"]


def test_multi_device_modules_import_without_jax():
    """The multi-device slice's modules by name: the robots mesh, the
    sharded banks, distributed PGO, the back end that runs it and the
    rank tool (the rank processes import only these)."""
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['cslam_tpu'] = None\n"
        "for name in ('utils.robot_mesh', 'matching.mesh_banks',\n"
        "             'pgo.distributed', 'runtime.backend_node',\n"
        "             'tools.dryrun_multichip'):\n"
        "    importlib.import_module('cslam_tpu_torch.' + name)\n"
        "from cslam_tpu_torch.pgo import distributed\n"
        "print(distributed.AXIS, distributed.distributed_optimize.__name__)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["robots", "distributed_optimize"]


def test_visual_modules_import_without_jax():
    """The visual slice's modules by name: the native loader and its numpy
    oracle, the visual verification, the RGB-D/stereo front ends, the
    visualization helpers and the map-manager factory."""
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['cslam_tpu'] = None\n"
        "for name in ('native', 'native.fallback',\n"
        "             'ops.visual_registration', 'runtime.rgbd_frontend',\n"
        "             'runtime.visualization', 'runtime.map_manager'):\n"
        "    importlib.import_module('cslam_tpu_torch.' + name)\n"
        "from cslam_tpu_torch.runtime import (CameraModel, RGBDFrontEnd,\n"
        "    StereoFrontEnd, make_map_manager)\n"
        "from cslam_tpu_torch import native\n"
        "print(StereoFrontEnd.__mro__[1].__name__, native._lib)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    # importing builds nothing: the library is built at first use
    assert out.stdout.split() == ["RGBDFrontEnd", "None"]


def test_deployment_modules_import_without_jax():
    """The deployment slice's modules by name: the experiment logger,
    snapshots, the PNG codec, the transport, the replay drivers and the
    two tools; the transport, like the JAX package's, starts without
    importing torch."""
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['cslam_tpu'] = None\n"
        "from cslam_tpu_torch.runtime.transport import NetworkBus, \\\n"
        "    TransportHub\n"
        "light = 'torch' in sys.modules\n"
        "for name in ('evaluation.logger', 'utils.snapshot', 'utils.png',\n"
        "             'utils.host_pickle', 'runtime.transport',\n"
        "             'runtime.replay', 'tools.kitti_replay',\n"
        "             'tools.multi_process_swarm'):\n"
        "    importlib.import_module('cslam_tpu_torch.' + name)\n"
        "from cslam_tpu_torch.evaluation import ExperimentLogger\n"
        "from cslam_tpu_torch.runtime.replay import ReplayDriver, \\\n"
        "    LidarReplayDriver\n"
        "print(light, ExperimentLogger.__name__,\n"
        "      LidarReplayDriver.__mro__[1].__name__, NetworkBus.__mro__[1]\n"
        "      .__name__, TransportHub.__name__)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "ExperimentLogger", "ReplayDriver",
                                  "MessageBus", "TransportHub"]


def test_scale_tools_import_without_jax():
    """The scale harness's tools by name: the PGO replay, the GNC scenario
    sweep, the lidar and visual scale missions, the verification bench and
    what they share."""
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['cslam_tpu'] = None\n"
        "for name in ('tools.harness', 'tools.pgo_replay',\n"
        "             'tools.gnc_scenario_sweep', 'tools.lidar_e2e_scale',\n"
        "             'tools.visual_e2e_scale', 'tools.verification_bench'):\n"
        "    importlib.import_module('cslam_tpu_torch.' + name)\n"
        "from cslam_tpu_torch.tools import gnc_scenario_sweep, pgo_replay\n"
        "print(len(gnc_scenario_sweep.TIERS), len(pgo_replay.FIELDS))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["4", "12"]


def test_source_scan_finds_no_jax_import():
    files = sorted((REPO / "cslam_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    offenders = [f"{p.relative_to(REPO)}: {m.group(0).strip()}"
                 for p in files for m in _FORBIDDEN.finditer(p.read_text())]
    assert offenders == []
    assert len(files) > 30


def _entry_points(params):
    from cslam_tpu_torch import resolve_device
    from cslam_tpu_torch.matching.nns_bank import DescriptorBank
    from cslam_tpu_torch.matching.sparse_matching import \
        LoopClosureSparseMatching
    from cslam_tpu_torch.pgo import FactorGraph
    from cslam_tpu_torch.runtime.simulator import (SwarmSimulator,
                                                   SyntheticWorld,
                                                   circle_trajectory)
    from cslam_tpu_torch.selection.mac import MAC
    from cslam_tpu_torch.types import Edge

    from cslam_tpu_torch.entry import entry
    from cslam_tpu_torch.matching.scancontext_bank import ScanContextBank
    from cslam_tpu_torch.models import make_global_descriptor
    from cslam_tpu_torch.ops import visual_registration as vreg
    from cslam_tpu_torch.ops.registration import compute_transform
    from cslam_tpu_torch.runtime import (CameraModel, MessageBus,
                                         RGBDFrontEnd, RobotContext,
                                         StereoFrontEnd, VirtualClock,
                                         make_map_manager)

    from cslam_tpu_torch.evaluation import ExperimentLogger
    from cslam_tpu_torch.runtime.replay import LidarReplayDriver, ReplayDriver
    from cslam_tpu_torch.tools.multi_process_swarm import run_swarm

    from cslam_tpu_torch.tools.dryrun_multichip import run_ranks
    from cslam_tpu_torch.utils.robot_mesh import StackedMesh

    from cslam_tpu_torch.tools import (gnc_scenario_sweep, lidar_e2e_scale,
                                       pgo_replay, verification_bench,
                                       visual_e2e_scale)

    def ctx(sensor="rgbd"):
        return RobotContext(MessageBus(), VirtualClock(), 0, {
            "robot_id": 0, "max_nb_robots": 2,
            "frontend.sensor_type": sensor})
    cam = CameraModel(300.0, 300.0, 160.0, 120.0, 0.2)
    z3, z2, v = np.zeros((1, 8, 3)), np.zeros((1, 8, 2)), np.ones((1, 8))
    graph = FactorGraph()
    graph.add_variable((0, 0), np.eye(4))
    world = SyntheticWorld(nb_places=4)
    return {
        "resolve_device": lambda: resolve_device(),
        "DescriptorBank": lambda: DescriptorBank(dim=8),
        "LoopClosureSparseMatching": lambda: LoopClosureSparseMatching(params),
        "MAC": lambda: MAC([Edge(0, 1, 1.0)], [Edge(1, 2, 1.0)], 3),
        "FactorGraph.to_arrays": graph.to_arrays,
        "SwarmSimulator": lambda: SwarmSimulator(
            1, world, [circle_trajectory(2, 1.0, 4)]),
        "make_global_descriptor": lambda: make_global_descriptor(
            {"frontend.nn_checkpoint": "random"}),
        "entry": entry,
        "ScanContextBank": lambda: ScanContextBank(),
        "ScanContext": lambda: make_global_descriptor(
            {"frontend.global_descriptor_technique": "scancontext"}),
        "compute_transform": lambda: compute_transform(
            np.zeros((4, 3)), np.zeros((4, 3)), 0.4, 40),
        "RGBDFrontEnd": lambda: RGBDFrontEnd(ctx(), cam),
        "StereoFrontEnd": lambda: StereoFrontEnd(ctx("stereo"), cam),
        "make_map_manager": lambda: make_map_manager(ctx("stereo"), cam),
        "gnc_align": lambda: vreg.gnc_align(z3[0], z3[0], v[0], 0.3),
        "gnc_align_batch": lambda: vreg.gnc_align_batch(z3, z3, v, 0.3),
        "gnc_pnp_batch": lambda: vreg.gnc_pnp_batch(z3, z2, v, z3, 300.0,
                                                    300.0, 160.0, 120.0),
        "verify_keyframe_pairs": lambda: vreg.verify_keyframe_pairs([]),
        "verify_keyframe_pairs_projective": lambda:
            vreg.verify_keyframe_pairs_projective([], 300.0, 300.0, 160.0,
                                                  120.0),
        "warmup_verification": lambda: vreg.warmup_verification((1,)),
        "ExperimentLogger": lambda: ExperimentLogger(ctx(), "unused"),
        "ReplayDriver": lambda: ReplayDriver([]),
        "LidarReplayDriver": lambda: LidarReplayDriver([]),
        "run_swarm": lambda: run_swarm(robots=1, duration=0.0),
        "StackedMesh": lambda: StackedMesh(2),
        "run_ranks": lambda: run_ranks(2),
        "pgo_replay.load": lambda: pgo_replay.load("unused.npz"),
        "gnc_scenario_sweep.sweep": lambda: gnc_scenario_sweep.sweep([]),
        "lidar_e2e_scale.run_mission": lambda: lidar_e2e_scale.run_mission(
            1, 1),
        "visual_e2e_scale.run_mission": lambda:
            visual_e2e_scale.run_mission(1, 1),
        "verification_bench.run": lambda: verification_bench.run(),
    }


@pytest.mark.parametrize("name", [
    "resolve_device", "DescriptorBank", "LoopClosureSparseMatching", "MAC",
    "FactorGraph.to_arrays", "SwarmSimulator", "make_global_descriptor",
    "entry", "ScanContextBank", "ScanContext", "compute_transform",
    "RGBDFrontEnd", "StereoFrontEnd", "make_map_manager", "gnc_align",
    "gnc_align_batch", "gnc_pnp_batch", "verify_keyframe_pairs",
    "verify_keyframe_pairs_projective", "warmup_verification",
    "ExperimentLogger", "ReplayDriver", "LidarReplayDriver", "run_swarm",
    "StackedMesh", "run_ranks", "pgo_replay.load",
    "gnc_scenario_sweep.sweep", "lidar_e2e_scale.run_mission",
    "visual_e2e_scale.run_mission", "verification_bench.run"])
def test_default_device_without_gpu_raises(monkeypatch, name):
    from helpers import matching_params
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU is available"):
        _entry_points(matching_params())[name]()


def test_cpu_tensors_take_the_plain_version():
    """The wrapper picks the plain version only because the tensor lies on
    the CPU, and never counts that as a kernel launch."""
    from cslam_tpu_torch.ops import nns
    before = nns.launches
    bank = torch.nn.functional.normalize(torch.randn(40, 8), dim=1)
    q = torch.randn(3, 8)
    got = nns.cosine_topk_scan(bank, 33, q, 4)
    ref = nns.cosine_topk_scan_ref(bank, 33, q, 4)
    assert torch.equal(got[1], ref[1]) and torch.equal(got[0], ref[0])
    assert nns.launches == before
    with pytest.raises(ValueError, match="no bank scan"):
        nns.cosine_topk_scan(bank.to("meta"), 33, q.to("meta"), 4)


def test_cpu_tensors_take_k2s_plain_version():
    """The same for K2, whose counter is its own: K1's stays put too."""
    from cslam_tpu_torch.ops import nns
    before, before_k1 = nns.tile_scan_launches, nns.launches
    bank = torch.randn(40, 8)
    inv = 1.0 / bank.norm(dim=1)
    q = torch.randn(3, 8)
    got = nns.cosine_topk_fused(bank, inv, 33, q, 4)
    ref = nns.cosine_topk_fused_ref(bank, inv, 33, q, 4)
    assert torch.equal(got[1], ref[1]) and torch.equal(got[0], ref[0])
    assert (nns.tile_scan_launches, nns.launches) == (before, before_k1)
    with pytest.raises(ValueError, match="no tile scan"):
        nns.cosine_topk_fused(bank.to("meta"), inv.to("meta"), 33,
                              q.to("meta"), 4)
