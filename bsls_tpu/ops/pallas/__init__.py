"""Pallas kernels for NVIDIA GPUs (Triton route).

The XLA implementations in ops.projection remain the CPU path and the
cross-check; ops.projection.proj_blocks picks the kernel when it lowers
for CUDA.
"""
from .projection_kernel import (
    MAX_KERNEL_WIDTH,
    proj_simplex_kernel,
    proj_simplex_rows,
    tile_shape,
)

__all__ = ["MAX_KERNEL_WIDTH", "proj_simplex_kernel", "proj_simplex_rows",
           "tile_shape"]
