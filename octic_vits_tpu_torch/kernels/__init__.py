"""Build and ctypes binding of the hand-written CUDA kernels (csrc/)."""

from octic_vits_tpu_torch.kernels.build import build, launch, library

__all__ = ["build", "launch", "library"]
