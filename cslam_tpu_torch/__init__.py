"""cslam_tpu_torch — the PyTorch/CUDA port of ``cslam_tpu``.

A second package beside the JAX one, with the same module layout so that
each module's counterpart is found at the same path. It imports ``torch``
and never ``jax``, and nothing of ``cslam_tpu``: host-only modules are
carried over as copies.

Entry points (``DescriptorBank``, ``LoopClosureSparseMatching``,
``SwarmSimulator``, ``FactorGraph.to_arrays`` and the solvers that run on
its tensors) run on the CUDA device unless the caller passes
``device="cpu"``; asking for the default device on a machine without a GPU
raises (:func:`resolve_device`). The one hand-written kernel so far is the
bank-scan top-k (``ops/nns.py`` + ``csrc/bank_scan.cu``); everything else
is plain PyTorch.
"""

__version__ = "0.1.0"

from cslam_tpu_torch.types import Edge, EdgeInterRobot  # noqa: F401


def resolve_device(device=None) -> "torch.device":  # noqa: F821
    """The device an entry point runs on: CUDA unless the caller asks for
    another. Never falls back silently: the default device on a machine
    without a GPU is an error. (``torch`` is imported here, not with the
    package, so that host-only modules such as the transport start
    without it.)"""
    import torch
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "cslam_tpu_torch runs on the CUDA device by default and no "
                "GPU is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
