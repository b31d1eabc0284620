"""Entropic mirror descent / exponentiated gradient solver.

The EG update x <- x * exp(-t g), renormalised per block, needs no
projection kernel at all (SURVEY.md §2 #10).  Modes:
  exact (default) — EG proposal, then closed-form quadratic step along the
                    segment d = x_eg - x (monotone descent)
  bb              — SPECTRAL mirror descent: the proposal's mirror step is
                    the Barzilai-Borwein length t_BB = (s.s)/(s.y) instead
                    of 1/L, with the same exact-segment safeguard.
  fixed           — classic EG with constant step (opts.step_size or 1/L)

MEASURED NEGATIVE RESULT (recorded so it is
not re-litigated): no step policy makes EG competitive with pgd/bb on the
medium-class quadratic.  On medium_sparse (f64 prototypes + on-device
runs, iterations to 1e-3 relative gap; pgd/bb needs ~100):
  exact-segment  rel=1.2e0 at 1000 iters;   bb (this mode)  rel=1.8e-1 at
  3200 (WORSE than exact at 3200: the long mirror step degenerates the
  proposal to a vertex probe);   Armijo-in-mirror with step doubling
  parity with exact;   AdaGrad diagonal (best eta=10)  rel=3.8e-1 at 1000.
The theory agrees: entropic MD is O(R_KL * L_inf / k) on smooth problems
and converges linearly only under relative strong convexity w.r.t. the
entropy, which a general LSQ quadratic does not have — while BB/PGD
exploit Euclidean curvature directly.  EG stays in the suite because
config 2 is literally "mirror descent vs projected gradient"
(BASELINE.json:8); for production use pgd/bb.  The bb mode is kept as the
standard spectral-MD variant with the safeguard making it safe, not fast.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..ops import layout as L, quadratic as Q
from ..ops.simplex import eg_update
from .base import SolveOptions, fw_gap

__all__ = ["EGState", "init", "step", "refresh"]


class EGState(NamedTuple):
    xp: tuple
    r: jnp.ndarray
    f: jnp.ndarray
    gap: jnp.ndarray
    k: jnp.ndarray
    x_prev: jnp.ndarray  # previous iterate, flat (BB spectral step)
    g_prev: jnp.ndarray  # previous gradient, flat


# sharding protocol (parallel.sharding.state_specs): field -> kind
EGState.SHARD_KINDS = {
    "xp": "x", "r": "r", "f": "scalar", "gap": "scalar", "k": "scalar",
    "x_prev": "xflat", "g_prev": "xflat",
}


def init(dp: L.DeviceProblem, L_est, opts: SolveOptions, xp0=None) -> EGState:
    xp = xp0 if xp0 is not None else L.feasible_init(dp)
    x_flat = L.padded_to_flat(dp, xp)
    r = Q.residual(dp, x_flat)
    return EGState(
        xp=xp, r=r, f=Q.objective_from_residual(dp, r),
        gap=jnp.asarray(jnp.inf, r.dtype), k=jnp.asarray(0, jnp.int32),
        x_prev=x_flat, g_prev=jnp.zeros_like(x_flat),
    )


def refresh(dp, st: EGState, L_est, opts: SolveOptions) -> EGState:
    r = Q.residual(dp, L.padded_to_flat(dp, st.xp))
    return st._replace(r=r, f=Q.objective_from_residual(dp, r))


def step(dp, st: EGState, L_est, opts: SolveOptions) -> EGState:
    x_flat = L.padded_to_flat(dp, st.xp)
    g_flat = Q.grad_flat(dp, st.r)
    gp = L.flat_to_padded(dp, g_flat)
    gap = fw_gap(dp, g_flat, x_flat, gp)

    if opts.step_size > 0:
        t0 = jnp.asarray(opts.step_size, x_flat.dtype)
    elif opts.line_search == "bb":
        # spectral (BB1) mirror step, safeguarded: fall back to 1/L on the
        # first iteration or when curvature along s is non-positive; cap at
        # 1e6/L so the log-domain proposal saturates at the block argmin
        # vertex (an FW-like probe) instead of overflowing the exponent
        s = x_flat - st.x_prev
        y = g_flat - st.g_prev
        ss = L.xdot(dp, s, s)
        sy = L.xdot(dp, s, y)
        t_bb = jnp.where(sy > 0, ss / jnp.maximum(sy, 1e-30), 1.0 / L_est)
        t_bb = jnp.clip(t_bb, 0.0, 1e6 / L_est)
        t0 = jnp.where(st.k > 0, t_bb, 1.0 / L_est).astype(x_flat.dtype)
    else:
        t0 = jnp.asarray(1.0, x_flat.dtype) / L_est
    x_eg = eg_update(st.xp, gp, t0, dp.buckets)
    dxp = tuple(xe - x for xe, x in zip(x_eg, st.xp))
    d_flat = L.padded_to_flat(dp, dxp)
    Ad = L.matvec_ps(dp, d_flat)
    if opts.line_search == "fixed":
        t = jnp.asarray(1.0, x_flat.dtype)
    else:
        t = Q.exact_step(dp, L.xdot(dp, g_flat, d_flat), Ad, 0.0, 1.0)

    xp_new = tuple(x + t * d for x, d in zip(st.xp, dxp))
    r_new = st.r + t * Ad
    return EGState(
        xp=xp_new, r=r_new, f=Q.objective_from_residual(dp, r_new), gap=gap,
        k=st.k + 1, x_prev=x_flat, g_prev=g_flat,
    )
