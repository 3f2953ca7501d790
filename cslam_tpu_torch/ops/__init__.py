"""Numeric cores (PyTorch + the hand-written CUDA bank scan)."""
import functools

import torch


def highest_precision(fn):
    """Run the wrapped solver with TF32 turned off for matmul and cuDNN.

    The counterpart of the JAX package's ``highest`` matmul-precision
    guard. On the card a float32 matrix product may use TF32 (about three
    decimal digits) when ``torch.backends.cuda.matmul.allow_tf32`` is set,
    and a float32 convolution does by default through
    ``torch.backends.cudnn.allow_tf32``: fine for ranking descriptors,
    ruinous for iterative solvers. This guard sets both flags to False
    around the call and restores the caller's values afterwards. Apply it
    to every linear-algebra-bearing solver entry point.
    """
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return fn(*args, **kwargs)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved
    return wrapper


def cholesky_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``A x = b`` for symmetric positive definite ``A`` by Cholesky.

    Where ``A`` is not positive definite the result is all NaN, as the JAX
    package's ``cho_factor`` + ``cho_solve`` give (``torch.linalg.cholesky``
    would raise): the solvers' accept/reject tests then reject the step.
    The choice is made on the device (no host read), so the solve can be
    captured in a CUDA graph.
    """
    L, info = torch.linalg.cholesky_ex(A)
    x = torch.cholesky_solve(b, L)
    return torch.where(info == 0, x, torch.full_like(x, float("nan")))
