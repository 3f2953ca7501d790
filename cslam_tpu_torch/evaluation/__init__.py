"""Trajectory evaluation and g2o I/O."""

from cslam_tpu_torch.evaluation.ate import absolute_trajectory_error  # noqa: F401
from cslam_tpu_torch.evaluation.logger import ExperimentLogger  # noqa: F401
