"""Robust pose-graph optimization (dense tier)."""

from cslam_tpu_torch.pgo.factor_graph import FactorGraph, PoseGraphArrays  # noqa: F401
from cslam_tpu_torch.pgo.solver import gnc_optimize, lm_optimize  # noqa: F401
