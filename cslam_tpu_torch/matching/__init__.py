"""Descriptor banks and sparse inter-robot matching."""

from cslam_tpu_torch.matching.nns_bank import DescriptorBank  # noqa: F401
from cslam_tpu_torch.matching.sparse_matching import LoopClosureSparseMatching  # noqa: F401
