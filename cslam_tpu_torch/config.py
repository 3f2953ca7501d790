"""Typed configuration tree with the reference's five dotted namespaces.

The reference declares ROS 2 parameters per node and flattens them into plain
dicts handed to library code (``cslam/loop_closure_detection_node.py:20-95``,
``src/back_end/pose_graph_manager_node.cpp:18-32``, ``cslam/lidar_handler_node.py:208-224``,
``config/cslam/example.yaml``). Here a single dataclass tree covers all nodes;
``flatten()`` produces the same dotted-key dict the library layer consumes, and
``from_dict()/from_yaml()`` accept dotted or nested overrides.

Namespaces: ``frontend.*``, ``backend.*``, ``neighbor_management.*``,
``evaluation.*``, ``visualization.*`` plus top-level ``robot_id`` /
``max_nb_robots``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class FrontendConfig:
    # --- detection (reference loop_closure_detection_node.py:20-46) ---
    similarity_threshold: float = 0.9
    global_descriptor_technique: str = "cosplace"
    nn_checkpoint: str = "disable"
    netvlad_pca_checkpoint: str = ""
    inter_robot_loop_closure_budget: int = 5
    inter_robot_detection_period_sec: float = 5.0
    nb_best_matches: int = 10
    image_crop_size: int = 376
    intra_loop_min_inbetween_keyframes: int = 10
    detection_publication_period_sec: float = 1.0
    detection_publication_max_elems_per_msg: int = 10
    enable_intra_robot_loop_closures: bool = False
    global_descriptors_topic: str = "global_descriptors"
    inter_robot_matches_topic: str = "inter_robot_matches"
    enable_sparsification: bool = True
    use_vertex_cover_selection: bool = True
    # best-effort keyframe intake (reference sensor-plane QoS,
    # rgbd_handler.cpp:58-61): bounded drop-oldest under overload
    keyframe_intake_best_effort: bool = True
    keyframe_intake_depth: int = 100
    cosplace_descriptor_dim: int = 64
    cosplace_backbone: str = "resnet18"
    sensor_type: str = "stereo"
    # --- sensor handlers (rgbd_handler.cpp:19-26, lidar_handler_node.py:208-224) ---
    # topic names + sync window: declared for reference-config parity
    # (this runtime feeds sensor callbacks directly, no topic remap needed)
    pointcloud_topic: str = "pointcloud"
    odom_topic: str = "odom"
    map_manager_process_period_ms: int = 100
    voxel_size: float = 0.5
    registration_min_inliers: int = 60
    keyframe_generation_ratio_distance: float = 0.5
    keyframe_generation_ratio_threshold: float = 1.0
    pointcloud_odom_approx_time_sync_s: float = 0.1
    max_queue_size: int = 10
    pnp_min_inliers: int = 6
    # visual verification residual: "3d3d" (GNC Kabsch over matched 3D
    # keypoints — needs valid depth on both sides) or "projective" (GNC
    # PnP over reprojection error, the reference's RANSAC-PnP decision
    # surface, rgbd_handler.cpp:493-554 — local depth only seeds the init)
    verification_residual: str = "3d3d"
    # --- TPU-native extras ---
    descriptor_dim: int = 64          # used by the 'disable' random-descriptor mode
    bank_initial_capacity: int = 1024  # padded bank tier start (doubles on growth)
    # device-mirror storage dtype for descriptor banks: "float32" (exact)
    # or "bfloat16" (halves HBM traffic per search pass; ~4e-3 relative
    # similarity error, far below the 0.9 detection-gate granularity)
    nns_bank_dtype: str = "float32"
    # opt-in: scan-context ring-key shortlist through the streaming NNS
    # kernel (euclidean-as-augmented-dot). Off until A/B'd on real
    # hardware — flip after benchmarks/scancontext_scale_bench.py
    # --fused-rk validates the tier on-chip
    scancontext_fused_stage1: bool = False
    # per-keyframe scan-context binning on the host (numpy twin of the
    # device op, bit-identical): a 20x60 max-binning over a few thousand
    # points is ~0.5 ms — cheaper than the device dispatch it replaces
    scancontext_host_binning: bool = True
    # pipelined detection rounds: detect_inter dispatches the MAC solve
    # and returns; the next poll cycle harvests it. Keeps the selection
    # plane off the keyframe critical path (the reference gets the same
    # isolation from its separate LCD process). Off = block in-round.
    async_detection: bool = True
    # staged geometric verification: registration bursts dispatch now and
    # harvest one stage per sensor cycle (LidarFrontEnd._advance_verifications)
    async_verification: bool = True
    # readiness-gated harvests (opt-in until chip-A/B'd): defer blocking
    # reads of aged search/embed results whose device programs are still
    # queued behind big programs on the serialized relay executor, up to
    # harvest_max_defer_sec; a ready result reads as a local-memory copy.
    harvest_ready_gate: bool = False
    harvest_max_defer_sec: float = 2.0
    # MAC Woodbury-tier LOBPCG budgets: first-stage iterations before the
    # residual-gated continuation (48 disables the early exit), and the
    # opt-in Frank-Wolfe warm start that carries the Ritz block across FW
    # iterations (shrinking the first stage to mac_lobpcg_warm_iters).
    # Default ON since the round-4 on-chip A/B: selections bit-identical
    # at every tier (sel_hash match) and the headline 10r/5000p/1000c
    # tier drops 5501 -> 4148 ms — under the 5 s detection period.
    mac_lobpcg_short_iters: int = 14
    mac_fw_warm_ritz: bool = True
    mac_lobpcg_warm_iters: int = 6
    # Carry the previous detection round's relaxed FW solution across
    # rounds (persisting candidates re-enter near their converged weight,
    # closing the duality gap in a few iterations — the cross-round
    # analogue of the PGO solver's carried TLS weights). Opt-in until A/B'd
    # on the real chip (benchmarks/selection_bench.py --fw-warm-start).
    mac_fw_warm_start: bool = False
    # Frank-Wolfe iteration budget per MAC solve (the reference's ACM
    # default, algebraic_connectivity_maximization.py:40). The rounded
    # top-k selection's objective is statistically flat past ~6
    # iterations on e2e-shaped graphs (benchmarks/fw_quality_probe.py) —
    # the budget is a wall-clock knob, not a quality one.
    mac_max_iters: int = 20
    # Track the best ROUNDED iterate inside the FW loop and return it
    # instead of rounding only the final iterate (the reference's
    # mac.py:229-233 behavior). Measured per-iteration, the rounded
    # objective fluctuates non-monotonically, so this is a strict quality
    # upgrade (mean +7-33% lambda_2 at equal budget on randomized
    # scenarios) for one extra eigensolve per iteration.
    mac_best_rounding: bool = True
    # Shape-tier floors for the fused FW program's candidate (E) and
    # non-chain-fixed (mf = verified loops) axes. Every distinct padded
    # shape compiles its own program (30-380 s each on the relay-attached
    # compile service), so a mission crossing a tier mid-run stalls the
    # detection plane; the round-5 lidar e2e verified 357+ loops and
    # crossed mf=512 twice. Padding is cheap on device (the E axis feeds a
    # top_k + one-hot, the mf axis a (mf+E) Cholesky — microseconds on the
    # MXU), so deployments should floor these ABOVE the mission's expected
    # totals; the small defaults keep CPU tests fast.
    mac_e_floor: int = 1024
    mac_mf_floor: int = 512
    # Pose-axis tier floor. The dense-T~inv Woodbury stack made solve
    # cost nearly P-independent (selection bench: 411 ms at P=512 dense
    # vs 418 ms at P=8192 Woodbury), so deployments can pin P to the
    # mission's pose bound: ONE FW program for the whole mission and no
    # P-crossing compiles. Default keeps the small-graph dense tiers
    # (fastest for short missions and CPU tests).
    mac_p_floor: int = 64
    # Skip a detection round's MAC solve when fewer than this many
    # candidate-pool mutations (new/updated matches, verified fixes,
    # removals) happened since the last dispatched solve — the previous
    # round's published selection already covers the unchanged pool, and
    # re-solving only re-spends the budget on its leftovers. 0 = solve
    # every round (the reference's behavior,
    # loop_closure_detection_node.py:26-27 fires detect_inter on a bare
    # timer regardless of pool changes).
    mac_min_new_candidates: int = 0
    # Bound the ACM candidate pool: when it exceeds this, the
    # lowest-weight candidates are evicted (NOT permanently — a stronger
    # re-match re-enters them). The pool otherwise grows without bound
    # (the reference's does too, acm.py:76-90) and every MAC solve pays
    # for the full padded E axis: the lidar e2e accumulated 8192
    # candidates by step ~140, compiling a 15-minute E=8192 Woodbury
    # program mid-run and slowing every subsequent solve — while the
    # per-round budget (5) only ever consumes ~350 of them. Capping at
    # the e-floor keeps ONE fast MAC program for the whole mission.
    # 0 = unbounded (reference behavior).
    max_candidate_pool: int = 0
    warmup_verification_tiers: tuple = ()  # gnc_align_batch pair tiers to precompile
    # local-descriptor payloads ship deflate-compressed, like the
    # reference's rtabmap-compressed features (rgbd_handler.cpp:404-431)
    compress_payloads: bool = True
    # lossy f16 pre-quantization of point/keypoint coords (~0.1% relative;
    # descriptors stay lossless). Off by default: reference keypoint data
    # is lossless too.
    compress_quantize_f16: bool = False


@dataclass
class BackendConfig:
    # reference pose_graph_manager_node.cpp:18-32, example.yaml:34-38
    pose_graph_optimization_start_period_ms: int = 500
    pose_graph_optimization_loop_period_ms: int = 100
    max_waiting_time_sec: float = 60.0
    enable_broadcast_tf_frames: bool = True
    enable_warm_start: bool = True   # re-init PGO from the last solution
    full_gnc_every_n_optimizations: int = 10  # periodic full GNC (weight recovery)
    # --- solver (replaces GTSAM GncOptimizer defaults, decentralized_pgo.cpp:805-808) ---
    gnc_max_outer_iterations: int = 100
    gnc_mu_step: float = 2.0  # 1.4 = GTSAM schedule; 2.0 measured identical quality, ~30% faster
    gnc_barc_sq: float = 16.81        # TLS inlier threshold (chi2(6) 99% quantile)
    # "centralized" = GNC at the elected optimizer (reference semantics);
    # "distributed" = mesh-sharded block Gauss-Seidel (one robot subgraph
    # per device, cslam_tpu.pgo.distributed) with centralized fallback
    # when fewer devices than robots are available
    pgo_mode: str = "centralized"
    distributed_max_sweeps: int = 30
    lm_max_iterations: int = 50
    lm_init_lambda: float = 1e-4
    cg_max_iterations: int = 200
    cg_tol: float = 1e-8
    rotation_default_noise_std: float = 0.01   # decentralized_pgo.cpp:64-70
    translation_default_noise_std: float = 0.1
    # --- distributed (TPU mesh) mode (pgo/distributed.py; driven directly
    #     on a device mesh — see __graft_entry__.dryrun_multichip) ---
    enable_distributed_pgo: bool = False
    distributed_gauss_seidel_iterations: int = 10
    # --- compilation ---
    compilation_cache_dir: str = ""   # persistent XLA cache (shared by robots)
    warmup_poses: int = 0             # precompile solver tiers at startup
    warmup_edges: int = 0
    # Mission-bound padded-tier floors for the aggregate solve (0 = grow
    # through power-of-two tiers). Pinning both to the mission bound makes
    # ONE compiled GNC program cover every optimization round — no
    # mid-mission tier-crossing recompiles (the MAC mac_*_floor design).
    pgo_np_floor: int = 0
    pgo_ne_floor: int = 0


@dataclass
class NeighborManagementConfig:
    enable_neighbor_monitoring: bool = False
    init_delay_sec: float = 5.0
    max_heartbeat_delay_sec: float = 5.0
    heartbeat_period_sec: float = 0.5


@dataclass
class EvaluationConfig:
    enable_logs: bool = False
    log_folder: str = ""
    enable_gps_recording: bool = False
    gps_topic: str = "gps/fix"
    enable_simulated_rendezvous: bool = False
    rendezvous_schedule_file: str = ""
    enable_pose_timestamps_recording: bool = False
    enable_sparsification_comparison: bool = False


@dataclass
class VisualizationConfig:
    enable: bool = False
    publishing_period_ms: int = 1000


@dataclass
class CslamConfig:
    robot_id: int = 0
    max_nb_robots: int = 10
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    backend: BackendConfig = field(default_factory=BackendConfig)
    neighbor_management: NeighborManagementConfig = field(
        default_factory=NeighborManagementConfig)
    evaluation: EvaluationConfig = field(default_factory=EvaluationConfig)
    visualization: VisualizationConfig = field(
        default_factory=VisualizationConfig)

    # -- dotted-dict interop (library layer consumes plain dicts, like the
    #    reference's flattened ROS params) --

    _NS_ALIASES = {
        "frontend.cosplace.descriptor_dim": "frontend.cosplace_descriptor_dim",
        "frontend.cosplace.backbone": "frontend.cosplace_backbone",
        "frontend.netvlad.pca_checkpoint": "frontend.netvlad_pca_checkpoint",
    }

    def flatten(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "robot_id": self.robot_id,
            "max_nb_robots": self.max_nb_robots,
        }
        for ns in ("frontend", "backend", "neighbor_management", "evaluation",
                   "visualization"):
            sub = getattr(self, ns)
            for f in dataclasses.fields(sub):
                out[f"{ns}.{f.name}"] = getattr(sub, f.name)
        # also expose the reference's exact dotted spellings
        out["frontend.cosplace.descriptor_dim"] = self.frontend.cosplace_descriptor_dim
        out["frontend.cosplace.backbone"] = self.frontend.cosplace_backbone
        out["frontend.netvlad.pca_checkpoint"] = self.frontend.netvlad_pca_checkpoint
        return out

    def set_dotted(self, key: str, value: Any) -> None:
        key = self._NS_ALIASES.get(key, key)
        if "." not in key:
            setattr(self, key, value)
            return
        ns, name = key.split(".", 1)
        name = name.replace(".", "_")
        sub = getattr(self, ns)
        if not hasattr(sub, name):
            raise KeyError(f"unknown config key: {key}")
        cur = getattr(sub, name)
        if cur is not None and value is not None and not isinstance(value, type(cur)):
            value = type(cur)(value)  # coerce e.g. int -> float
        setattr(sub, name, value)

    @classmethod
    def from_dict(cls, d: Dict[str, Any],
                  base: Optional["CslamConfig"] = None) -> "CslamConfig":
        cfg = base if base is not None else cls()
        for k, v in _flatten_nested(d).items():
            cfg.set_dotted(k, v)
        return cfg

    @classmethod
    def from_yaml(cls, path: str) -> "CslamConfig":
        import yaml
        with open(path) as f:
            data = yaml.safe_load(f)
        # accept the reference's ROS layout (`/**: ros__parameters: {...}`)
        if isinstance(data, dict) and "/**" in data:
            data = data["/**"].get("ros__parameters", {})
        return cls.from_dict(data)


def _flatten_nested(d: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten_nested(v, f"{key}."))
        else:
            out[key] = v
    return out
