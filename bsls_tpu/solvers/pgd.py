"""Projected gradient solver (x-space sort-projection or z-space PAVA).

Line-search modes (SURVEY.md §2 #6-9):
  exact  — candidate x^ = proj(x - t0 g), then closed-form quadratic step
           along d = x^ - x (monotone descent, 2 matvecs/iter)
  pava   — same but in z-space: candidate z^ = iso_[0,1](z - t0 D^T g) via
           the PAVA kernel; direction mapped back linearly (the reference's
           "PAVA-based line search", BASELINE.json:11)
  bb     — Barzilai-Borwein step, projected (non-monotone, cheapest)
  bbm    — monotone safeguarded BB: the projected BB candidate is kept only
           if it descends; otherwise the exact quadratic step along the
           same direction (guaranteed descent: d is a projection-arc
           direction, g.d < 0) replaces the unit step.  Same 2
           matvecs/iter as bb, monotone like exact, converges at the BB
           rate in practice — the honest fast time-to-1e-6 solver.
  fixed  — constant step (opts.step_size or 1/L)
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import isotonic, layout as L, projection, quadratic as Q, ztransform as Z
from .base import SolveOptions, fw_gap

__all__ = ["PGDState", "init", "step", "refresh"]


class PGDState(NamedTuple):
    xp: tuple
    r: jnp.ndarray
    f: jnp.ndarray
    gap: jnp.ndarray
    k: jnp.ndarray
    x_prev: jnp.ndarray  # previous iterate, flat, for BB (x- or z-space)
    g_prev: jnp.ndarray  # previous gradient, flat, same space


# sharding protocol (parallel.sharding.state_specs): field -> kind
PGDState.SHARD_KINDS = {
    "xp": "x", "r": "r", "f": "scalar", "gap": "scalar", "k": "scalar",
    "x_prev": "xflat", "g_prev": "xflat",
}


def _dz_forward(dzp, buckets):
    """Linear part of z->x per bucket (see ztransform.dz_forward_padded)."""
    return tuple(Z.dz_forward_padded(dz, bk.mask) for dz, bk in zip(dzp, buckets))


def init(dp: L.DeviceProblem, L_est, opts: SolveOptions, xp0=None) -> PGDState:
    xp = xp0 if xp0 is not None else L.feasible_init(dp)
    x_flat = L.padded_to_flat(dp, xp)
    r = Q.residual(dp, x_flat)
    f = Q.objective_from_residual(dp, r)
    return PGDState(
        xp=xp, r=r, f=f,
        gap=jnp.asarray(jnp.inf, f.dtype),
        k=jnp.asarray(0, jnp.int32),
        x_prev=x_flat,
        g_prev=jnp.zeros_like(x_flat),
    )


def refresh(dp, st: PGDState, L_est, opts: SolveOptions) -> PGDState:
    x_flat = L.padded_to_flat(dp, st.xp)
    r = Q.residual(dp, x_flat)
    return st._replace(r=r, f=Q.objective_from_residual(dp, r))


def step(dp, st: PGDState, L_est, opts: SolveOptions) -> PGDState:
    x_flat = L.padded_to_flat(dp, st.xp)
    g_flat = Q.grad_flat(dp, st.r)
    gp = L.flat_to_padded(dp, g_flat)
    gap = fw_gap(dp, g_flat, x_flat, gp)
    zspace = opts.line_search == "pava" or opts.space == "z"

    # when the trial point is built in z-space, the whole trial-step logic
    # (1/L, BB differences) must live in z-space too: the cumulative-sum map
    # D inflates curvature to ||A D||^2 = O(w^2)||A||^2, so x-space steps are
    # orders too long there.  solve() passes the
    # matching power_lipschitz_z estimate as L_est for these modes.
    if zspace:
        zp = tuple(Z.x_to_z_padded(x, bk.mask) for x, bk in zip(st.xp, dp.buckets))
        gzp = tuple(Z.dz_adjoint_padded(g, bk.mask) for g, bk in zip(gp, dp.buckets))
        u_flat = L.padded_to_flat(dp, zp)
        gu_flat = L.padded_to_flat(dp, gzp)
    else:
        zp = gzp = None
        u_flat, gu_flat = x_flat, g_flat

    if opts.step_size > 0:
        t0 = jnp.asarray(opts.step_size, x_flat.dtype)
    else:
        t0 = jnp.asarray(1.0, x_flat.dtype) / L_est
    if opts.line_search in ("bb", "bbm") or zspace:
        # z-space modes always take the spectral (BB) trial step: the exact
        # segment step below is clipped to t<=1 (feasibility of the z-segment),
        # so a 1/L_z trial — with L_z = O(w^2)||A||^2 — would cap per-iteration
        # progress at the tiny trial step itself.  BB adapts to the local
        # curvature; the exact safeguard keeps pava monotone.
        du = u_flat - st.x_prev
        dg = gu_flat - st.g_prev
        t_bb = Q.bb_step(L.xdot(dp, du, du), L.xdot(dp, du, dg), fallback=t0)
        t0 = jnp.where(st.k > 0, t_bb, t0)

    if zspace:
        zhat = tuple(
            isotonic.pava_bounded(
                z - t0 * gz, jnp.maximum(bk.sizes - 1, 0), bk.radius
            )
            for z, gz, bk in zip(zp, gzp, dp.buckets)
        )
        dzp = tuple(zh - z for zh, z in zip(zhat, zp))
        dxp = _dz_forward(dzp, dp.buckets)
    else:
        cand = tuple(x - t0 * g for x, g in zip(st.xp, gp))
        xhat = projection.proj_blocks(cand, dp.buckets)
        dxp = tuple(xh - x for xh, x in zip(xhat, st.xp))

    d_flat = L.padded_to_flat(dp, dxp)
    Ad = L.matvec_ps(dp, d_flat)
    if opts.line_search == "exact":
        t = Q.exact_step(dp, L.xdot(dp, g_flat, d_flat), Ad, 0.0, 1.0)
    elif opts.line_search in ("bbm", "pava"):
        # pava shares the monotone BB safeguard: an always-exact segment step
        # re-caps progress at the trial step (measured 10.0 vs 2.89 objective
        # at 300 iters on medium) — unit-if-descends keeps the BB rate AND
        # monotonicity.
        # monotone safeguard: unit BB step if it descends, else the exact
        # quadratic minimiser along the same (descent) direction
        g_dot_d = L.xdot(dp, g_flat, d_flat)
        dAAd = L.rdot(dp, Ad, Ad)
        f_unit = st.f + g_dot_d + 0.5 * dAAd  # f(x+d), exact for a quadratic
        t_exact = jnp.clip(-g_dot_d / jnp.maximum(dAAd, 1e-30), 0.0, 1.0)
        t = jnp.where(f_unit <= st.f, jnp.asarray(1.0, x_flat.dtype), t_exact)
    else:
        t = jnp.asarray(1.0, x_flat.dtype)

    xp_new = tuple(x + t * d for x, d in zip(st.xp, dxp))
    r_new = st.r + t * Ad
    f_new = Q.objective_from_residual(dp, r_new)
    return PGDState(
        xp=xp_new, r=r_new, f=f_new, gap=gap, k=st.k + 1,
        x_prev=u_flat, g_prev=gu_flat,
    )
