"""Quadratic objective helpers and line searches.

The objective 0.5||Ax-b||^2 admits a closed-form exact step along any
direction d:  t* = -(g.d)/||A d||^2, clipped to the feasible segment — the
vectorised equivalent of the reference's C line-search helpers (SURVEY.md
§2 #5-7).  Under the sharded step these inner products become psum
reductions (parallel/sharding.py).
"""
from __future__ import annotations

import jax.numpy as jnp

import jax

from .layout import (
    DeviceDense, DeviceEll, DeviceProblem, DeviceVStack, flat_to_padded,
    matvec_ps, rdot, rmatvec_ps,
)

__all__ = [
    "residual",
    "objective_from_residual",
    "grad_flat",
    "exact_step",
    "bb_step",
    "diag_quad",
]


def _diag_flat(A) -> jnp.ndarray:
    from .banded import DeviceBanded

    if isinstance(A, DeviceBanded):
        parts = []
        for band, L in zip(A.bands, A.seg_lens):
            Mp, C, _ = band.shape
            d = jnp.sum(band * band, axis=-1).reshape(Mp * C)[:L]
            parts.append(d)
        d = jnp.concatenate(parts) if len(parts) > 1 else parts[0]
        return d if A.resid is None else d + _diag_flat(A.resid)
    if isinstance(A, DeviceDense):
        return jnp.sum(A.data * A.data, axis=0)
    if isinstance(A, DeviceEll):
        if A.grid_sharded:  # (nr, nc, n_loc, ks): row-partials, cols concat
            d = jnp.sum(A.vals * A.vals, axis=(0, -1))  # (nc, n_loc)
            return d.reshape(-1)
        if A.row_sharded:  # (nr, n_pf, ks): per-shard partials (psum'd by caller)
            return jnp.sum(A.vals * A.vals, axis=(0, -1))
        return jnp.sum(A.vals * A.vals, axis=-1)
    if isinstance(A, DeviceVStack):
        return _diag_flat(A.top) + A.bottom_scale**2 * _diag_flat(A.bottom)
    raise TypeError(f"unsupported device matrix {type(A)}")


def diag_quad(dp: DeviceProblem) -> tuple:
    """diag(A^T A) as padded buckets (squared column norms in the PF layout;
    the per-block diagonal curvature used to size pairwise-FW transfers).
    Column entries are column-local under column sharding; under row
    sharding the per-row partials psum."""
    d = _diag_flat(dp.A)
    if dp.row_axis:
        d = jax.lax.psum(d, dp.row_axis)
    return flat_to_padded(dp, d)


def residual(dp: DeviceProblem, x_flat: jnp.ndarray, b=None) -> jnp.ndarray:
    """r = A x - b; under a column(block)-sharded mesh the partial matvec
    psums; under a row-sharded mesh this is the local row segment."""
    return matvec_ps(dp, x_flat) - (dp.b if b is None else b)


def objective_from_residual(dp: DeviceProblem, r: jnp.ndarray) -> jnp.ndarray:
    return 0.5 * rdot(dp, r, r)


def grad_flat(dp: DeviceProblem, r: jnp.ndarray) -> jnp.ndarray:
    return rmatvec_ps(dp, r)


def exact_step(dp: DeviceProblem, g_dot_d: jnp.ndarray, Ad: jnp.ndarray,
               t_lo=0.0, t_hi=1.0) -> jnp.ndarray:
    """Exact minimiser of f(x + t d) over [t_lo, t_hi].

    f(x+td) = f(x) + t g.d + t^2/2 ||Ad||^2  =>  t* = -g.d / ||Ad||^2.
    """
    den = rdot(dp, Ad, Ad)
    t = -g_dot_d / jnp.maximum(den, 1e-30)
    return jnp.clip(t, t_lo, t_hi)


def bb_step(dx_dot_dx, dx_dot_dg, fallback, t_lo=1e-12, t_hi=1e12):
    """Barzilai-Borwein step t = (dx.dx)/(dx.dg), guarded for non-positive curvature."""
    t = dx_dot_dx / jnp.where(dx_dot_dg > 0, dx_dot_dg, 1.0)
    ok = (dx_dot_dg > 1e-30) & jnp.isfinite(t)
    return jnp.clip(jnp.where(ok, t, fallback), t_lo, t_hi)
