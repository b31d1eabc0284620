"""Batched bounded isotonic regression (PAVA-equivalent) — XLA implementation.

Vectorised replacement for the reference's C ``isotonic_regression_c`` /
``isotonic_regression_multi_c`` (SURVEY.md §2 #3-4).  PAVA is inherently
sequential per block, but blocks are small (w <= ~128), so this uses the
exact *minimax characterisation* of L2 isotonic regression instead:

    yhat_i = min_{k >= i} max_{j <= i} mean(y[j..k])

which vectorises as an O(w^2) dense computation per block — a far better
fit for wide vector hardware than a length-w dependency chain, and exactly equal to the
PAVA output.  Uniform box bounds commute with the monotone-cone projection,
so [lo, hi] is applied as a final clip.

Cost is O(B * w^2) and the means tensor is (chunk, w, w); ``chunk`` bounds
peak memory for very large B.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["pava_padded", "pava_blocks"]


def _pava_minimax(y: jnp.ndarray, sizes: jnp.ndarray) -> jnp.ndarray:
    """Nondecreasing isotonic fit of each row's first ``sizes`` entries.

    y: (B, w); sizes: (B,) int. Entries past the width are ignored/garbage.
    """
    import numpy as np

    B, w = y.shape
    dt = y.dtype
    big = jnp.asarray(jnp.finfo(dt).max, dt)
    # prefix sums with leading zero: P[:, k] = sum(y[:, :k])
    ym = jnp.where(jnp.arange(w) < sizes[:, None], y, 0.0)
    P = jnp.concatenate([jnp.zeros((B, 1), dt), jnp.cumsum(ym, axis=-1)], axis=-1)
    j = np.arange(w)[:, None]  # segment start (static)
    k = np.arange(w)[None, :]  # segment end, inclusive (static)
    J = np.broadcast_to(j, (w, w))
    K1 = np.broadcast_to(k + 1, (w, w))
    seg_len = jnp.asarray((k - j + 1).astype(np.float32), dt)
    # mean over y[j..k] (static gathers on the prefix sums)
    M = (P[:, K1] - P[:, J]) / seg_len
    M = jnp.where(jnp.asarray(j <= k), M, -big)
    A = jax.lax.cummax(M, axis=1)  # A[:, i, k] = max_{j<=i} M[j, k]
    valid_k = jnp.asarray(k >= j)[None] & (jnp.arange(w)[None, None, :] < sizes[:, None, None])
    out = jnp.min(jnp.where(valid_k, A, big), axis=-1)
    return out


def pava_padded(
    y: jnp.ndarray,
    mask: jnp.ndarray,
    lo: float | None = 0.0,
    hi: float | None = 1.0,
    increasing: bool = True,
    chunk: int = 4096,
) -> jnp.ndarray:
    """Bounded isotonic regression on each row of a padded (B, w) array.

    Only the first ``width`` (from mask) entries of each row are fit; padding
    slots return 0.  Leading batch dims are vmapped.
    """
    if y.ndim > 2:
        return jax.vmap(lambda yy: pava_padded(yy, mask, lo, hi, increasing, chunk))(y)
    B, w = y.shape
    sizes = jnp.sum(mask > 0, axis=-1).astype(jnp.int32)
    sgn = 1.0 if increasing else -1.0
    yy = sgn * y
    if w == 1:
        out = yy
    elif B <= chunk:
        out = _pava_minimax(yy, sizes)
    else:
        pad = (-B) % chunk
        ypad = jnp.pad(yy, ((0, pad), (0, 0)))
        spad = jnp.pad(sizes, (0, pad))
        out = jax.lax.map(
            lambda args: _pava_minimax(*args),
            (ypad.reshape(-1, chunk, w), spad.reshape(-1, chunk)),
        ).reshape(-1, w)[:B]
    out = sgn * out
    if lo is not None or hi is not None:
        lo_a = None if lo is None else jnp.asarray(lo, y.dtype)
        hi_a = None if hi is None else jnp.asarray(hi, y.dtype)
        if hi_a is not None and hi_a.ndim >= 1:
            hi_a = hi_a[..., None]  # per-row upper bound (B, 1)
        if lo_a is not None and lo_a.ndim >= 1:
            lo_a = lo_a[..., None]
        out = jnp.clip(out, lo_a, hi_a)
    return jnp.where(mask > 0, out, 0.0)


def pava_bounded(y: jnp.ndarray, widths: jnp.ndarray, radius) -> jnp.ndarray:
    """[0, radius]-bounded nondecreasing fit of each row's first ``widths``
    slots (XLA minimax form; leading batch axes broadcast)."""
    mask = (jnp.arange(y.shape[-1]) < widths[:, None]).astype(y.dtype)
    return pava_padded(y, mask, 0.0, radius)


def pava_blocks(yp, buckets):
    """Apply [0, radius]-bounded isotonic regression per bucket (z-space
    projection onto the radius-scaled order simplex)."""
    return tuple(pava_bounded(y, bk.sizes, bk.radius) for y, bk in zip(yp, buckets))
