"""Budgeted loop-closure selection (MAC) and the vertex-cover broker."""

from cslam_tpu_torch.selection.acm import AlgebraicConnectivityMaximization  # noqa: F401
from cslam_tpu_torch.selection.broker import Broker  # noqa: F401
from cslam_tpu_torch.selection.mac import MAC  # noqa: F401
