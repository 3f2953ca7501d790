"""Global-descriptor (visual/lidar place recognition) models.

Counterpart of ``cslam_tpu/models/__init__.py``: the factory mirrors the
reference's technique selection
(``cslam/global_descriptor_loop_closure_detection.py:42-60``). CosPlace and
NetVLAD are the VPR models; ScanContext is the lidar descriptor.
"""
from __future__ import annotations


def make_global_descriptor(params: dict, device=None):
    """Instantiate the configured global-descriptor model on ``device``
    (CUDA unless the caller asks for another).

    Returns an object with ``compute_embedding(keyframe) -> np.ndarray`` —
    the duck-typed interface shared by all techniques (reference
    ``netvlad.py:212``, ``cosplace.py:81``, ``scancontext.py:14``).
    """
    technique = params.get("frontend.global_descriptor_technique",
                           "cosplace").lower()
    if technique == "netvlad":
        from cslam_tpu_torch.models.netvlad import NetVLAD
        return NetVLAD(params, device=device)
    if technique == "scancontext":
        from cslam_tpu_torch.models.scancontext import ScanContext
        return ScanContext(params, device=device)
    from cslam_tpu_torch.models.cosplace import CosPlace
    return CosPlace(params, device=device)
