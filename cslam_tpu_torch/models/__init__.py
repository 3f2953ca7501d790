"""Global-descriptor (visual/lidar place recognition) models.

Counterpart of ``cslam_tpu/models/__init__.py``: the factory mirrors the
reference's technique selection
(``cslam/global_descriptor_loop_closure_detection.py:42-60``). The models
themselves (CosPlace, NetVLAD, ScanContext) are not ported yet (ROADMAP.md
item 10, the VPR models): asking for one raises. The simulator passes its
own descriptor model and never calls this factory.
"""
from __future__ import annotations

def make_global_descriptor(params: dict):
    """Instantiate the configured global-descriptor model (not ported yet
    for any technique; see the module docstring)."""
    technique = params.get("frontend.global_descriptor_technique",
                           "cosplace").lower()
    raise NotImplementedError(
        f"global-descriptor model {technique!r} is not ported yet "
        "(ROADMAP.md item 10, the VPR models); pass a model object with "
        "compute_embedding() instead")
