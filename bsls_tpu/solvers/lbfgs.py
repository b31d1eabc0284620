"""Projected L-BFGS solver (x-space sort-projection or z-space PAVA).

The quasi-Newton family the reference codebase pairs with its z-space
reparametrisation (SURVEY.md §1a solver table: "L-BFGS-in-z-space"
[UNVERIFIED — reference mount empty]; this build implements both the
x-space and z-space variants).  Scheme per iteration:

  1. the limited-memory inverse-Hessian product q = H g is evaluated in
     the COMPACT representation (Byrd, Nocedal & Schnabel, "Representations
     of quasi-Newton matrices...", Math. Prog. 63, 1994):

         H = gamma I + [S  gamma Y] W [S  gamma Y]^T,
         W = [[R^{-T}(D + gamma Y^T Y)R^{-1},  -R^{-T}], [-R^{-1}, 0]]

     with R = triu(S^T Y), D = diag(S^T Y).  This needs two batched
     (M, n) @ (n,) history products and two MxM triangular solves — a
     serial depth of ~4 ops — where the classic two-loop recursion is 2M
     strictly dependent dot+AXPY stages (M=8 → 16 serial reductions; the
     two-loop's unrolled graph also made XLA compiles of huge instances
     blow up).  The two-loop is kept below as the cross-check oracle.
  2. candidate = proj(x - q)  (sort-projection in x-space, bounded
     isotonic/PAVA in z-space) — the projection-arc direction
     d = candidate - x is tested for descent (g.d < 0) and otherwise
     replaced by the plain projected-gradient direction at step 1/L;
  3. exact quadratic line search along d (closed form, collective-aware
     inner products) — monotone descent by construction.

Accelerator-first shape choices: the pair history lives in two static (M, n_pf)
SHIFT buffers (newest pair at index M-1, advanced with a static
slice+concat each iteration) plus MxM Gram buffers S^T Y and Y^T Y
maintained incrementally, so the whole step stays a fixed-shape XLA
program under jit/scan/vmap/shard_map with NO scatters and NO serial
reduction chains.  Empty/rejected slots carry rho = 0 and are masked out
of the Gram matrices (their R diagonal is pinned to 1 so the triangular
solves pass zeros through).  All n-length dots go through
``layout.xdot``/``layout.xmatdot`` so the mesh-sharded path psums them
exactly like the first-order solvers.

On a convex quadratic the curvature condition s.y > 0 holds wherever
s != 0 (y = A^T A s), so pairs are only rejected at numerical noise
level; a rejected pair still shifts a zeroed (rho = 0) slot into the
buffers and the masking skips it.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import isotonic, layout as L, projection, quadratic as Q, ztransform as Z
from .base import SolveOptions, fw_gap
from .pgd import _dz_forward

__all__ = ["LBFGSState", "init", "step", "refresh"]


class LBFGSState(NamedTuple):
    xp: tuple
    r: jnp.ndarray
    f: jnp.ndarray
    gap: jnp.ndarray
    k: jnp.ndarray
    u_prev: jnp.ndarray  # previous iterate, flat (x- or z-space)
    g_prev: jnp.ndarray  # previous gradient, flat (same space)
    s_hist: jnp.ndarray  # (M, n_pf) shift buffer of iterate differences (newest last)
    y_hist: jnp.ndarray  # (M, n_pf) shift buffer of gradient differences
    rho_hist: jnp.ndarray  # (M,) 1/(s.y), 0 marks an empty/rejected slot
    sty: jnp.ndarray  # (M, M) Gram s_i . y_j (maintained incrementally)
    yty: jnp.ndarray  # (M, M) Gram y_i . y_j
    gamma: jnp.ndarray  # H0 scaling (s.y)/(y.y) of the newest pair


# sharding protocol (parallel.sharding.state_specs): field -> kind
LBFGSState.SHARD_KINDS = {
    "xp": "x", "r": "r", "f": "scalar", "gap": "scalar", "k": "scalar",
    "u_prev": "xflat", "g_prev": "xflat",
    "s_hist": "xflat_hist", "y_hist": "xflat_hist",
    "rho_hist": "hist", "sty": "gram", "yty": "gram",
    "gamma": "scalar",
}


def compact_hg(dp, g_flat, st: LBFGSState):
    """q = H g via the compact (BNS) representation — two batched history
    products + two MxM triangular solves, no serial reduction chain."""
    valid = st.rho_hist > 0  # (M,)
    pair_mask = valid[:, None] & valid[None, :]
    u = jnp.where(valid, L.xmatdot(dp, st.s_hist, g_flat), 0.0)
    v = jnp.where(valid, L.xmatdot(dp, st.y_hist, g_flat), 0.0)
    # R = triu(S^T Y) over valid pairs; invalid diagonal pinned to 1 so the
    # solves carry zeros through those slots
    R = jnp.triu(jnp.where(pair_mask, st.sty, 0.0))
    R = R + jnp.diag(jnp.where(valid, 0.0, 1.0).astype(R.dtype))
    D = jnp.where(valid, jnp.diagonal(st.sty), 0.0)
    YtY = jnp.where(pair_mask, st.yty, 0.0)
    w1 = jax.scipy.linalg.solve_triangular(R, u, lower=False)  # R^{-1} u
    t = D * w1 + st.gamma * jnp.matmul(
        YtY, w1, precision=jax.lax.Precision.HIGHEST) - st.gamma * v
    p = jax.scipy.linalg.solve_triangular(R.T, t, lower=True)  # R^{-T} t
    hp = jnp.einsum("mn,m->n", st.s_hist, p,
                    precision=jax.lax.Precision.HIGHEST)
    hw = jnp.einsum("mn,m->n", st.y_hist, w1,
                    precision=jax.lax.Precision.HIGHEST)
    return st.gamma * g_flat + hp - st.gamma * hw


def two_loop_hg(dp, g_flat, st: LBFGSState):
    """q = H g via the classic two-loop recursion (Nocedal & Wright ch.
    7.2) — 2M serially dependent stages.  Kept as the cross-check oracle
    for ``compact_hg`` (tests/test_solvers.py)."""
    M = st.rho_hist.shape[-1]
    q = g_flat
    stages = []
    for t in range(M):
        j = M - 1 - t
        s, y, rho = st.s_hist[j], st.y_hist[j], st.rho_hist[j]
        alpha = jnp.where(rho > 0, rho * L.xdot(dp, s, q), 0.0)
        q = q - alpha * y
        stages.append((j, alpha))
    q = st.gamma * q
    for j, alpha in reversed(stages):
        s, y, rho = st.s_hist[j], st.y_hist[j], st.rho_hist[j]
        beta = jnp.where(rho > 0, rho * L.xdot(dp, y, q), 0.0)
        q = q + s * (alpha - beta)
    return q


def init(dp: L.DeviceProblem, L_est, opts: SolveOptions, xp0=None) -> LBFGSState:
    if opts.line_search not in ("exact",):
        raise ValueError(
            f"method 'lbfgs' does not support line_search={opts.line_search!r}; "
            "the quasi-Newton arc always uses the exact quadratic line search"
        )
    if opts.step_size > 0:
        raise ValueError(
            "method 'lbfgs' ignores step_size; the trial step is H g from "
            "the curvature memory (use method='pgd' for fixed steps)"
        )
    xp = xp0 if xp0 is not None else L.feasible_init(dp)
    x_flat = L.padded_to_flat(dp, xp)
    r = Q.residual(dp, x_flat)
    f = Q.objective_from_residual(dp, r)
    M = max(int(opts.lbfgs_mem), 1)
    n = x_flat.shape[-1]
    dt = x_flat.dtype
    return LBFGSState(
        xp=xp, r=r, f=f,
        gap=jnp.asarray(jnp.inf, f.dtype),
        k=jnp.asarray(0, jnp.int32),
        u_prev=x_flat,
        g_prev=jnp.zeros_like(x_flat),
        s_hist=jnp.zeros((M, n), dt),
        y_hist=jnp.zeros((M, n), dt),
        rho_hist=jnp.zeros((M,), dt),
        sty=jnp.zeros((M, M), dt),
        yty=jnp.zeros((M, M), dt),
        gamma=jnp.asarray(1.0, dt) / L_est,
    )


def refresh(dp, st: LBFGSState, L_est, opts: SolveOptions) -> LBFGSState:
    x_flat = L.padded_to_flat(dp, st.xp)
    r = Q.residual(dp, x_flat)
    return st._replace(r=r, f=Q.objective_from_residual(dp, r))


def _shift_gram(G, row, col):
    """Shift an MxM Gram buffer up-left and write the new last row/col."""
    G = jnp.zeros_like(G).at[:-1, :-1].set(G[1:, 1:])
    G = G.at[-1, :].set(row)
    return G.at[:, -1].set(col)


def update_pairs(dp, st: LBFGSState, u_flat, gu_flat) -> LBFGSState:
    """Append the (s, y) pair from the previous iterate to the shift
    buffers and maintain the MxM Gram matrices incrementally."""
    s = u_flat - st.u_prev
    y = gu_flat - st.g_prev
    sy = L.xdot(dp, s, y)
    ss = L.xdot(dp, s, s)
    yy = L.xdot(dp, y, y)
    valid = (st.k > 0) & (sy > 1e-10 * jnp.sqrt(ss * yy) + 1e-30)
    rho_new = jnp.where(valid, 1.0 / jnp.maximum(sy, 1e-30), 0.0)
    zero = jnp.zeros_like(s)
    s_m = jnp.where(valid, s, zero)
    y_m = jnp.where(valid, y, zero)
    # shift (drop oldest, append newest) — static slices, scatter-free
    s_hist = jnp.concatenate([st.s_hist[1:], s_m[None]], axis=0)
    y_hist = jnp.concatenate([st.y_hist[1:], y_m[None]], axis=0)
    rho_hist = jnp.concatenate([st.rho_hist[1:], rho_new[None]], axis=0)
    # Gram updates: one batched product per matrix against the new pair
    sty = _shift_gram(st.sty, L.xmatdot(dp, y_hist, s_m),  # s_new . y_j
                      L.xmatdot(dp, s_hist, y_m))          # s_i . y_new
    row_y = L.xmatdot(dp, y_hist, y_m)
    yty = _shift_gram(st.yty, row_y, row_y)
    gamma = jnp.where(valid, sy / jnp.maximum(yy, 1e-30), st.gamma)
    return st._replace(s_hist=s_hist, y_hist=y_hist, rho_hist=rho_hist,
                       sty=sty, yty=yty, gamma=gamma)


def step(dp, st: LBFGSState, L_est, opts: SolveOptions) -> LBFGSState:
    x_flat = L.padded_to_flat(dp, st.xp)
    g_flat = Q.grad_flat(dp, st.r)
    gp = L.flat_to_padded(dp, g_flat)
    gap = fw_gap(dp, g_flat, x_flat, gp)
    zspace = opts.space == "z"

    if zspace:
        # reparametrise: u = z (order simplex), grad_u = D^T g
        zp = tuple(Z.x_to_z_padded(x, bk.mask) for x, bk in zip(st.xp, dp.buckets))
        gzp = tuple(Z.dz_adjoint_padded(g, bk.mask) for g, bk in zip(gp, dp.buckets))
        u_flat = L.padded_to_flat(dp, zp)
        gu_flat = L.padded_to_flat(dp, gzp)
    else:
        zp = gzp = None
        u_flat, gu_flat = x_flat, g_flat

    st = update_pairs(dp, st, u_flat, gu_flat)

    # ---- quasi-Newton projection-arc candidate ----
    q = compact_hg(dp, gu_flat, st)
    t0 = jnp.asarray(1.0, x_flat.dtype) / L_est
    if zspace:
        qp = L.flat_to_padded(dp, q)
        gz_t0 = tuple(t0 * g for g in gzp)
        zhat_qn = tuple(
            isotonic.pava_bounded(z - dq, jnp.maximum(bk.sizes - 1, 0), bk.radius)
            for z, dq, bk in zip(zp, qp, dp.buckets)
        )
        zhat_gd = tuple(
            isotonic.pava_bounded(z - g, jnp.maximum(bk.sizes - 1, 0), bk.radius)
            for z, g, bk in zip(zp, gz_t0, dp.buckets)
        )
        d_qn = _dz_forward(tuple(zh - z for zh, z in zip(zhat_qn, zp)), dp.buckets)
        d_gd = _dz_forward(tuple(zh - z for zh, z in zip(zhat_gd, zp)), dp.buckets)
    else:
        qp = L.flat_to_padded(dp, q)
        xhat_qn = projection.proj_blocks(
            tuple(x - dq for x, dq in zip(st.xp, qp)), dp.buckets)
        xhat_gd = projection.proj_blocks(
            tuple(x - t0 * g for x, g in zip(st.xp, gp)), dp.buckets)
        d_qn = tuple(xh - x for xh, x in zip(xhat_qn, st.xp))
        d_gd = tuple(xh - x for xh, x in zip(xhat_gd, st.xp))

    # descent safeguard: keep the QN arc only if it is a descent direction
    gd_qn = L.xdot(dp, g_flat, L.padded_to_flat(dp, d_qn))
    use_qn = gd_qn < -1e-30
    dxp = tuple(jnp.where(use_qn, a, b) for a, b in zip(d_qn, d_gd))

    # ---- exact quadratic line search along the chosen direction ----
    d_flat = L.padded_to_flat(dp, dxp)
    Ad = L.matvec_ps(dp, d_flat)
    t = Q.exact_step(dp, L.xdot(dp, g_flat, d_flat), Ad, 0.0, 1.0)

    xp_new = tuple(x + t * d for x, d in zip(st.xp, dxp))
    r_new = st.r + t * Ad
    f_new = Q.objective_from_residual(dp, r_new)
    return st._replace(
        xp=xp_new, r=r_new, f=f_new, gap=gap, k=st.k + 1,
        u_prev=u_flat, g_prev=gu_flat,
    )
