"""Fused block-simplex projection for NVIDIA GPUs (Pallas, Triton route).

The XLA path (ops.projection.proj_simplex_padded) sorts each row, takes a
cumsum, finds the pivot and writes the output as separate passes over the
(..., B, w) slot array.  This kernel reads each row once and writes it once:
one program owns a tile of ``TB`` rows of the row-major (N, w) array, with
the width padded to the next power of two ``W`` inside the kernel and the
padding masked.

Threshold without a sort: for the radius-r simplex the projection is
max(v - tau, 0) with

    tau = max_i (S_i - r) / c_i,   c_i = #{j : v_j >= v_i},
                                   S_i = sum{v_j : v_j >= v_i}

over the row's valid slots (arXiv:1101.6081: (css_k - r)/k rises while k is
in the support and falls after it, so its maximum over the sorted prefixes
is the threshold; evaluating it at every slot visits every prefix, ties
included).  That is O(W^2) compares per row on a (TB, W, W) register tile
and is exact, no iteration.  It beats the sort path on an H100 up to
W = 16, the widest padded width measured (PERF.md); wider buckets take the
sort path (``MAX_KERNEL_WIDTH``).

A vmapped scenario axis folds into rows by a reshape ((S, B, w) ->
(S*B, w)); the per-block widths and radii stay (B,) and row n reads block
n % B.  ``interpret=True`` runs the same kernel on the CPU for tests.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["MAX_KERNEL_WIDTH", "proj_simplex_kernel", "proj_simplex_rows",
           "tile_shape"]

# widest block the kernel takes; wider buckets use the XLA sort path
MAX_KERNEL_WIDTH = 16
# register tile per program: TB*W*W elements, sized by a tile/warp sweep on
# an H100 (PERF.md)
_TILE = 4096
_MAX_ROWS = 256
_NUM_WARPS = 4


def tile_shape(w: int) -> tuple[int, int]:
    """(W, TB): the power-of-two padded width and the rows per program."""
    W = pl.next_power_of_2(max(int(w), 1))
    return W, max(1, min(_MAX_ROWS, _TILE // (W * W)))


def _kernel(v_ref, width_ref, radius_ref, out_ref, *, W: int, TB: int):
    n_rows, w = v_ref.shape
    n_blk = width_ref.shape[0]
    rows = pl.program_id(0) * TB + jnp.arange(TB)
    cols = jnp.arange(W)
    row_ok = rows < n_rows
    blk = rows % n_blk
    width = plgpu.load(width_ref.at[blk], mask=row_ok, other=0)
    radius = plgpu.load(radius_ref.at[blk], mask=row_ok, other=1.0)
    in_bounds = row_ok[:, None] & (cols[None, :] < w)
    v = plgpu.load(v_ref.at[rows[:, None], cols[None, :]], mask=in_bounds,
                   other=0.0)
    valid = in_bounds & (cols[None, :] < width[:, None])
    big = float(jnp.finfo(v.dtype).max)
    vj = jnp.where(valid, v, -big)[:, None, :]  # (TB, 1, W)
    ge = vj >= v[:, :, None]  # ge[t, i, j]: v_j >= v_i over valid j
    cnt = jnp.sum(jnp.where(ge, 1.0, 0.0).astype(v.dtype), axis=2)
    ssum = jnp.sum(jnp.where(ge, vj, 0.0), axis=2)
    cand = jnp.where(valid, (ssum - radius[:, None]) / jnp.maximum(cnt, 1.0),
                     -big)
    tau = jnp.max(cand, axis=1, keepdims=True)
    out = jnp.where(valid, jnp.maximum(v - tau, 0.0), 0.0)
    plgpu.store(out_ref.at[rows[:, None], cols[None, :]], out.astype(out_ref.dtype),
                mask=in_bounds)


@functools.partial(jax.jit, static_argnames=("interpret",))
def proj_simplex_rows(v, widths, radius, interpret: bool = False):
    """Project every row of ``v`` (..., B, w) onto the radius-scaled simplex
    of its block's first ``widths`` slots; leading axes fold into rows.

    widths, radius: (B,) per block.  Padding slots and width-0 rows give 0.
    """
    w = v.shape[-1]
    if w > MAX_KERNEL_WIDTH:
        raise ValueError(f"block width {w} > MAX_KERNEL_WIDTH={MAX_KERNEL_WIDTH}")
    W, TB = tile_shape(w)
    v2 = v.reshape(-1, w)
    out = pl.pallas_call(
        functools.partial(_kernel, W=W, TB=TB),
        # vma: inside shard_map the output varies over the same mesh axes
        out_shape=jax.ShapeDtypeStruct(v2.shape, v.dtype,
                                       vma=jax.typeof(v2).vma),
        grid=(pl.cdiv(v2.shape[0], TB),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="proj_simplex",
    )(v2, widths.astype(jnp.int32), jnp.broadcast_to(
        jnp.asarray(radius, v.dtype), widths.shape))
    return out.reshape(v.shape)


@jax.custom_batching.custom_vmap
def proj_simplex_kernel(v, widths, radius):
    """Solver-facing entry: ``v`` (B, w), ``widths``/``radius`` (B,).  A
    vmapped scenario axis folds into the kernel's rows (one launch over
    S*B rows), not a serial loop over scenarios."""
    return proj_simplex_rows(v, widths, radius)


@proj_simplex_kernel.def_vmap
def _fold(axis_size, in_batched, v, widths, radius):
    if in_batched[1] or in_batched[2]:
        # per-scenario block parameters: every row carries its own block
        def lead(x, batched):
            return x if batched else jnp.broadcast_to(x, (axis_size,) + x.shape)

        v = lead(v, in_batched[0])
        widths = lead(widths, in_batched[1]).reshape(-1)
        radius = lead(radius, in_batched[2]).reshape(-1)
        return proj_simplex_kernel(v.reshape(widths.shape[0], v.shape[-1]),
                                   widths, radius).reshape(v.shape), True
    if not in_batched[0]:
        v = jnp.broadcast_to(v, (axis_size,) + v.shape)
    out = proj_simplex_kernel(v.reshape(-1, v.shape[-1]), widths, radius)
    return out.reshape(v.shape), True
