"""Batched block-simplex projection — XLA implementation.

Sort-based algorithm (arXiv:1101.6081, PAPERS.md): per block, sort
descending, find the pivot rho = max{k : u_k - (cumsum_k - 1)/k > 0},
threshold tau = (cumsum_rho - 1)/rho, return max(v - tau, 0).

This is the vectorised equivalent of the reference's C ``proj_simplex_c`` /
``proj_multi_simplex_c`` (SURVEY.md §2 #1-2).  Operates on a padded
``(..., B, w)`` layout with a ``(B, w)`` validity mask; padding slots and
all-padding dummy rows produce zeros.  The fused GPU kernel lives in
``bsls_tpu.ops.pallas.projection_kernel``; this XLA version is the CPU path,
the path for blocks wider than the kernel takes, and the cross-check.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .pallas.projection_kernel import MAX_KERNEL_WIDTH, proj_simplex_kernel

__all__ = ["proj_simplex_padded", "proj_blocks"]


def proj_simplex_padded(v: jnp.ndarray, mask: jnp.ndarray, radius=1.0) -> jnp.ndarray:
    """Project each row of ``v`` (..., B, w) onto the radius-scaled simplex of
    its valid slots: {x >= 0 on valid slots, sum x = radius}.

    mask: (B, w) (or broadcastable) with 1.0 on real slots.  ``radius`` is a
    scalar or a per-row (B,) array (block equilibration).  Rows whose mask is
    all zero (dummy blocks) return all zeros.
    """
    dt = v.dtype
    neg = jnp.asarray(jnp.finfo(dt).min, dt)
    w = v.shape[-1]
    rad = jnp.asarray(radius, dt)
    if rad.ndim >= 1:
        rad = rad[..., None]  # (B, 1) broadcast over slots
    vm = jnp.where(mask > 0, v, neg)
    u = -jnp.sort(-vm, axis=-1)  # descending
    css = jnp.cumsum(jnp.where(u > neg, u, 0.0), axis=-1)
    k = jnp.arange(1, w + 1, dtype=dt)
    widths = jnp.sum(mask > 0, axis=-1, keepdims=True)  # (..., B, 1) int
    valid_k = jnp.arange(1, w + 1) <= widths
    cond = (u * k > (css - rad)) & valid_k
    idx = jnp.arange(w)
    rho = jnp.max(jnp.where(cond, idx, -1), axis=-1)  # (..., B)
    rho_c = jnp.maximum(rho, 0)
    css_rho = jnp.take_along_axis(css, rho_c[..., None], axis=-1)
    tau = (css_rho - rad) / (rho_c + 1)[..., None].astype(dt)
    out = jnp.maximum(v - tau, 0.0)
    return jnp.where(mask > 0, out, 0.0)


def _proj_bucket(x, bk):
    if x.shape[-1] > MAX_KERNEL_WIDTH:
        return proj_simplex_padded(x, bk.mask, bk.radius)
    # the fused kernel when lowering for CUDA, the sort path elsewhere (the
    # branch not taken is traced but never lowered)
    return jax.lax.platform_dependent(
        x, bk.sizes, bk.radius, bk.mask,
        cuda=lambda v, s, r, m: proj_simplex_kernel(v, s, r),
        default=lambda v, s, r, m: proj_simplex_padded(v, m, r),
    )


def proj_blocks(xp, buckets):
    """Apply the projection to every bucket of a padded pytree (per-bucket
    radii from equilibration)."""
    return tuple(_proj_bucket(x, bk) for x, bk in zip(xp, buckets))
