"""Per-block simplex ops: entropic-mirror (EG) update and Frank-Wolfe vertex.

Vectorised equivalents of the reference's mirror-descent renormalisation and
FW linear-minimisation oracle (SURVEY.md §2 #10-11).  All run on the padded
(B, w) layout with masks; EG runs in the log domain for underflow safety
(SURVEY.md §7 hard part 5).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "eg_update_padded", "eg_update", "fw_vertex_padded", "fw_vertex",
    "pairwise_direction_padded", "pairwise_direction", "block_min",
]

_NEG = -1e30


def _rad(radius, dtype):
    r = jnp.asarray(radius, dtype)
    return r[..., None] if r.ndim >= 1 else r


def eg_update_padded(x: jnp.ndarray, g: jnp.ndarray, t, mask: jnp.ndarray, radius=1.0) -> jnp.ndarray:
    """One exponentiated-gradient step per block: x <- x*exp(-t g) renormalised
    to the block's radius.

    Computed as radius * softmax(log x - t g) over valid slots.  Zero
    coordinates stay zero (log 0 = -inf handled via the mask floor).
    """
    logx = jnp.where((x > 0) & (mask > 0), jnp.log(jnp.maximum(x, 1e-38)), _NEG)
    s = logx - t * g
    s = jnp.where(mask > 0, s, _NEG)
    smax = jnp.max(s, axis=-1, keepdims=True)
    e = jnp.exp(s - smax) * (mask > 0)
    denom = jnp.sum(e, axis=-1, keepdims=True)
    out = _rad(radius, x.dtype) * e / jnp.maximum(denom, 1e-38)
    return jnp.where(mask > 0, out, 0.0)


def eg_update(xp, gp, t, buckets):
    return tuple(
        eg_update_padded(x, g, t, bk.mask, bk.radius)
        for x, g, bk in zip(xp, gp, buckets)
    )


def fw_vertex_padded(g: jnp.ndarray, mask: jnp.ndarray, radius=1.0) -> jnp.ndarray:
    """Frank-Wolfe LMO on a product of (radius-scaled) simplices:
    radius * one_hot(argmin) per block.  Dummy rows return all zeros."""
    big = jnp.asarray(jnp.finfo(g.dtype).max, g.dtype)
    gm = jnp.where(mask > 0, g, big)
    amin = jnp.argmin(gm, axis=-1)
    out = _rad(radius, g.dtype) * jax.nn.one_hot(amin, g.shape[-1], dtype=g.dtype)
    row_valid = jnp.any(mask > 0, axis=-1, keepdims=True)
    return jnp.where(row_valid, out, 0.0)


def fw_vertex(gp, buckets):
    return tuple(fw_vertex_padded(g, bk.mask, bk.radius) for g, bk in zip(gp, buckets))


def pairwise_direction_padded(
    x: jnp.ndarray, g: jnp.ndarray, mask: jnp.ndarray, q=None
) -> jnp.ndarray:
    """Per-block pairwise Frank-Wolfe direction, per-block step-sized.

    On a simplex the iterate's coordinates ARE its vertex weights, so the
    away vertex needs no active-set bookkeeping (Lacoste-Julien & Jaggi,
    arXiv:1511.05932): v = argmax_{j in supp(x)} g_j, s = argmin_j g_j, and
    the pairwise direction transfers weight w from v to s:

        d_b = w_b * (e_s - e_v),   0 <= w_b <= x_v  keeps t in [0,1] feasible.

    With ``q`` = diag(A^T A) in the same padded layout, the transfer is
    *diagonally Newton-sized*: the 1-D restriction of f along e_s - e_v has
    curvature q_s - 2(A^T A)_{sv} + q_v, approximated (cross term dropped)
    by q_s + q_v, giving w* = (g_v - g_s)/(q_s + q_v) clipped to the away
    weight.  A single global exact line search over the assembled direction
    (t in [0,1]) safeguards the approximation — every block term has
    g.d_b <= 0, so the direction is a descent direction whenever the FW gap
    is nonzero.  Without ``q`` the transfer is maximal (w = x_v).
    """
    big = jnp.asarray(jnp.finfo(g.dtype).max, g.dtype)
    gm = jnp.where(mask > 0, g, big)
    amin = jnp.argmin(gm, axis=-1)
    on_supp = (mask > 0) & (x > 0)
    ga = jnp.where(on_supp, g, -big)
    amax = jnp.argmax(ga, axis=-1)
    oh_s = jax.nn.one_hot(amin, g.shape[-1], dtype=g.dtype)
    oh_v = jax.nn.one_hot(amax, g.shape[-1], dtype=g.dtype)
    x_v = jnp.sum(x * oh_v, axis=-1, keepdims=True)  # away weight (no gather)
    if q is None:
        w = x_v
    else:
        g_s = jnp.sum(g * oh_s, axis=-1, keepdims=True)
        g_v = jnp.sum(g * oh_v, axis=-1, keepdims=True)
        q_s = jnp.sum(q * oh_s, axis=-1, keepdims=True)
        q_v = jnp.sum(q * oh_v, axis=-1, keepdims=True)
        tiny = jnp.asarray(jnp.finfo(g.dtype).tiny, g.dtype)
        w = jnp.minimum(x_v, (g_v - g_s) / jnp.maximum(q_s + q_v, tiny))
        w = jnp.maximum(w, 0.0)
    row_valid = jnp.any(on_supp, axis=-1, keepdims=True)
    return jnp.where(row_valid, w * (oh_s - oh_v), 0.0)


def pairwise_direction(xp, gp, buckets, qp=None):
    if qp is None:
        qp = (None,) * len(buckets)
    return tuple(
        pairwise_direction_padded(x, g, bk.mask, q)
        for x, g, bk, q in zip(xp, gp, buckets, qp)
    )


def block_min(g: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Per-block min over valid slots (0 for dummy rows): used for the FW gap."""
    big = jnp.asarray(jnp.finfo(g.dtype).max, g.dtype)
    m = jnp.min(jnp.where(mask > 0, g, big), axis=-1)
    return jnp.where(jnp.any(mask > 0, axis=-1), m, 0.0)
