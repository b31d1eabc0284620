"""Device-side problem layout: the padded-flat ("PF") data path.

Key design decision: instead of gather/scatter between the
user's flat x ordering and the padded per-bucket rectangles every iteration,
the columns of A are permuted **once at prepare time** into *device-major,
bucket-minor, padded* order — one (zero) column per padded slot.  Then

    padded buckets  <-> PF flat vector      is a reshape/concat (free), and
    block-sharding the buckets on a mesh    slices A's columns contiguously,

so the hot loop contains no gathers at all: matvec, A^T r, per-block kernels
and reshapes only.  The cost is a bounded fraction of zero columns in A
(padding waste < 2x within a bucket, typically ~15%).

``reduce_axis`` marks a DeviceProblem as shard-local: cross-device inner
products and residual assembly then psum over that mesh axis (the
BASELINE.json:5 "block-local compute with psum/all-reduce collectives").
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..models.partition import BlockPartition
from ..models.problem import DenseMatrix, EllMatrix, Problem, ScaledMatrix, VStackMatrix

__all__ = [
    "DeviceDense",
    "DeviceEll",
    "DeviceVStack",
    "DeviceBucket",
    "DeviceProblem",
    "build_pf_perm",
    "to_device_matrix",
    "prepare",
    "flat_to_padded",
    "padded_to_flat",
    "extract_user_flat",
    "matvec",
    "rmatvec",
    "matvec_ps",
    "pvdot",
    "psum_if_sharded",
    "feasible_init",
]


def _register(cls, data_fields, meta_fields):
    jax.tree_util.register_dataclass(cls, data_fields=data_fields, meta_fields=meta_fields)
    return cls


@dataclass(frozen=True)
class DeviceDense:
    data: jnp.ndarray  # (m, n_pf)


_register(DeviceDense, ["data"], [])


@dataclass(frozen=True)
class DeviceEll:
    """Dual-ELL sparse matrix on device: gathers only, no scatters.

    Column-oriented arrays (rows/vals, from models.problem.EllMatrix) drive
    A^T r as a gather; a row-oriented copy (mv_cols/mv_vals, built at
    prepare time per block-shard with *local* PF column indices) drives
    A @ x as a gather, so the hot loop never scatters — the sparse-matvec
    design decision of SURVEY.md §7 hard part 2 (kept from the first build,
    whose device serialised scatters; whether one orientation suffices on
    the current device is not yet measured).

    Unsharded instances use *row-nnz bucketing*: gather cost scales with
    the gathered rows, so padding every row to the max nnz wastes rows
    3-4x.  At prepare time rows are permuted so nnz counts are ascending
    (b permuted to match — the row order of a least-squares system is
    arbitrary) and grouped into power-of-two widths; mv_cols/mv_vals are
    then TUPLES of (m_k, w_k) arrays whose partial results concatenate
    contiguously.  Column-sharded instances (shard_map slices by leading
    axis) keep the single (n_shards, m, kr) layout.  A pathological kr >
    ROW_ELL_MAX_K drops the row copy (None) -> segment_sum fallback.

    Row-sharded instances (``row_sharded=True``, the tall-A / SP-analog:
    SURVEY.md §2b) re-encode BOTH orientations per row shard at prepare
    time:
      rows/vals: (nr, n_pf, ks) with LOCAL row ids — each shard's slice
                 gathers from its local r segment; A^T r partials psum
                 over the row axis.
      mv_cols/mv_vals: (nr, m_loc, kr) with global PF column indices — x
                 is replicated, so A @ x is shard-local and r never needs
                 a collective.
    """

    rows: jnp.ndarray  # (n_pf, k) int32 — column-oriented (for A^T r)
    vals: jnp.ndarray  # (n_pf, k)
    mv_cols: Optional[object]  # tuple[(m_k, w_k)] or (n_shards, m, kr) int32
    mv_vals: Optional[object]  # matching values
    num_rows: int  # static
    row_sharded: bool = False  # static: leading axis of ALL arrays is a row shard
    grid_sharded: bool = False  # static: leading TWO axes are (row, col) shards
    # col-nnz-bucketed A^T r copy (unsharded instances): columns sorted by
    # nonzero count into a few width groups so padding slots are never
    # gathered; partials concatenate in sorted-column order and one final
    # (n_pf,)-row gather (rt_inv) restores PF order.  Cuts gathered rows
    # ~k_max/avg_nnz-fold on ragged-column instances.
    rt_rows: Optional[tuple] = None  # tuple[(n_g, w_g)] int32
    rt_vals: Optional[tuple] = None
    rt_inv: Optional[jnp.ndarray] = None  # (n_pf,) int32 rank in sorted order
    rt_zeros: int = 0  # static: count of zero-nnz columns (emitted as zeros)


_register(
    DeviceEll,
    ["rows", "vals", "mv_cols", "mv_vals", "rt_rows", "rt_vals", "rt_inv"],
    ["num_rows", "row_sharded", "grid_sharded", "rt_zeros"],
)

ROW_ELL_MAX_K = 512


@dataclass(frozen=True)
class DeviceVStack:
    """[top; scale*bottom] vertical stack; the scale is a traced leaf so the
    augmented-Lagrangian rho can change without recompiling."""

    top: "DeviceMatrix"
    bottom: "DeviceMatrix"
    bottom_scale: jnp.ndarray  # scalar
    split: int  # static: rows in top


_register(DeviceVStack, ["top", "bottom", "bottom_scale"], ["split"])

DeviceMatrix = Union[DeviceDense, DeviceEll, "DeviceVStack"]


@dataclass(frozen=True)
class DeviceBucket:
    mask: jnp.ndarray  # (Bk, w) 1.0 real / 0.0 padding
    sizes: jnp.ndarray  # (Bk,) int32 true block sizes (0 for dummy rows)
    radius: jnp.ndarray  # (Bk,) simplex radius per block (block equilibration)
    width: int  # static


_register(DeviceBucket, ["mask", "sizes", "radius"], ["width"])


@dataclass(frozen=True)
class DeviceProblem:
    """Device-side problem.  Sharding is described by two optional mesh axes
    (the 2-D sharded-matvec pattern of SURVEY.md §2b — blockwise compute +
    collectives, the same shape ring attention uses):

      col_axis — A's columns (and x) sharded by block: A@x psums partials
                 over it; x-space inner products psum over it.
      row_axis — A's rows (and r) sharded (the SP/CP analog for tall A):
                 A^T r psums partials over it; r-space inner products psum
                 over it.

    Either, both, or neither may be set; all collective placement in the
    solvers flows through matvec_ps/rmatvec_ps/xdot/rdot below."""

    A: DeviceMatrix
    b: jnp.ndarray  # (m,) single scenario or (S, m)
    buckets: tuple  # tuple[DeviceBucket, ...]
    perm: jnp.ndarray  # (n_pf,) int32: user-flat index per PF slot, -1 = pad
    n_user: int  # static: user flat length N
    num_rows: int  # static
    col_axis: Optional[str] = None  # static: mesh axis sharding A columns
    row_axis: Optional[str] = None  # static: mesh axis sharding A rows
    row_perm: Optional[jnp.ndarray] = None  # (m,) original row id per
    # device-row position (set when row-nnz bucketing permuted the rows)

    @property
    def n_pf(self) -> int:
        return self.perm.shape[0]

    @property
    def reduce_axis(self):  # back-compat alias
        return self.col_axis


_register(
    DeviceProblem,
    ["A", "b", "buckets", "perm", "row_perm"],
    ["n_user", "num_rows", "col_axis", "row_axis"],
)


# ---------------- preparation (host side, numpy) ----------------


def build_pf_perm(part: BlockPartition, n_shards: int = 1) -> np.ndarray:
    """PF column order: device-major, bucket-minor, row-major, slot-minor.

    Returns (n_pf,) int32: the user-flat column index of each PF slot, or -1
    for padding slots.  Requires every bucket's row count to divide n_shards.
    """
    chunks = []
    for d in range(n_shards):
        for b in part.buckets:
            Bk = b.num_blocks
            if Bk % n_shards:
                raise ValueError(
                    f"bucket with {Bk} rows not divisible by n_shards={n_shards}; "
                    f"rebuild the partition with block_multiple={n_shards}"
                )
            lo, hi = d * Bk // n_shards, (d + 1) * Bk // n_shards
            p2f = b.pad_to_flat[lo:hi]
            real = b.mask[lo:hi] > 0
            chunks.append(np.where(real, p2f, -1).astype(np.int32).reshape(-1))
    perm = np.concatenate(chunks)
    assert perm.size == part.padded_size
    return perm


def _build_row_ell_bucketed(rows_pf, vals_pf, num_rows: int):
    """Row-nnz-bucketed row-ELL (unsharded): returns
    (row_perm, mv_cols_tuple, mv_vals_tuple) where row_perm sorts rows by
    nonzero count ascending and the tuples hold (m_k, w_k) groups whose
    matvec partials concatenate to y in *permuted* row order.
    """
    n_pf, k = rows_pf.shape
    nz = vals_pf != 0
    counts = np.zeros(num_rows, np.int64)
    np.add.at(counts, rows_pf[nz], 1)
    if counts.max() > ROW_ELL_MAX_K:
        return None, None, None
    row_perm = np.argsort(counts, kind="stable")
    rank = np.empty(num_rows, np.int64)
    rank[row_perm] = np.arange(num_rows)
    counts_sorted = counts[row_perm]

    # nonzeros grouped by permuted row (native single-pass ELL encode),
    # position within row; groups then slice off the full-width encode
    from ..native import group_ell

    pf_pos = np.broadcast_to(np.arange(n_pf)[:, None], (n_pf, k))[nz].astype(np.int32)
    r_new = rank[rows_pf[nz]]
    v = vals_pf[nz]
    full_cols, full_vals = group_ell(r_new, pf_pos, v, num_rows)

    # power-of-two bucket widths over the sorted-row space; min width 4
    # bounds the number of gather groups (compile time grows with op
    # count) while keeping most of the row savings
    widths = []
    mx = max(int(counts_sorted.max()), 1)
    w = min(4, mx)
    while w < mx:
        widths.append(w)
        w *= 2
    widths.append(mx)
    widths = sorted(set(widths))
    mv_cols, mv_vals = [], []
    lo = 0
    for w in widths:
        hi = int(np.searchsorted(counts_sorted, w, side="right"))
        if hi <= lo:
            continue
        mv_cols.append(np.ascontiguousarray(full_cols[lo:hi, :w]))
        mv_vals.append(np.ascontiguousarray(full_vals[lo:hi, :w]))
        lo = hi
    assert lo == num_rows, (lo, num_rows)
    return row_perm, tuple(mv_cols), tuple(mv_vals)


def _build_row_ell(rows_pf, vals_pf, num_rows: int, n_shards: int):
    """Build the row-oriented (gather) ELL copy from PF column-oriented data.

    rows_pf/vals_pf: (n_pf, k) with zeros on padding.  Returns
    (mv_cols, mv_vals) of shape (n_shards, m, kr) with *local* PF column
    indices, or (None, None) if kr would exceed ROW_ELL_MAX_K.
    """
    from ..native import group_ell

    n_pf, k = rows_pf.shape
    n_loc = n_pf // n_shards
    nz = vals_pf != 0
    if not nz.any():
        return (
            np.zeros((n_shards, num_rows, 1), np.int32),
            np.zeros((n_shards, num_rows, 1), vals_pf.dtype),
        )
    pf_pos = np.broadcast_to(np.arange(n_pf)[:, None], (n_pf, k))[nz]
    r = rows_pf[nz].astype(np.int64)
    v = vals_pf[nz]
    shard = pf_pos // n_loc
    local = (pf_pos % n_loc).astype(np.int32)
    key = shard.astype(np.int64) * num_rows + r
    # reject on the PER-(shard,row) width (a popular row split across
    # shards is still fine), before group_ell allocates the (G, W) arrays
    if np.bincount(key, minlength=n_shards * num_rows).max() > ROW_ELL_MAX_K:
        return None, None
    mv_cols, mv_vals = group_ell(key, local, v, n_shards * num_rows)
    kr = mv_cols.shape[1]
    return (
        mv_cols.reshape(n_shards, num_rows, kr),
        mv_vals.reshape(n_shards, num_rows, kr),
    )


def _build_col_ell_bucketed(rows_pf, vals_pf, max_groups: int = 6):
    """Col-nnz-bucketed A^T r layout: sort PF columns by nonzero count into
    <= max_groups width groups (widths = count quantiles, so padding beyond
    a column's own count is bounded by the group spread).  Returns
    (rt_rows, rt_vals, rt_inv, n_zero): group tuples in ascending-count
    order, the PF->sorted-position rank, and the number of zero-nnz columns
    (those are never gathered — their g entries are emitted as zeros)."""
    n_pf, k = rows_pf.shape
    nz = vals_pf != 0
    counts = nz.sum(axis=1)
    # compact each column's nonzeros into the leading slots (interior zeros
    # would otherwise be dropped by the [:w] slice below)
    cidx = np.argsort(~nz, axis=1, kind="stable")
    rows_pf = np.take_along_axis(rows_pf, cidx, axis=1)
    vals_pf = np.take_along_axis(vals_pf, cidx, axis=1)
    order = np.argsort(counts, kind="stable")
    rank = np.empty(n_pf, np.int64)
    rank[order] = np.arange(n_pf)
    counts_sorted = counts[order]
    n_zero = int(np.searchsorted(counts_sorted, 1))
    pos = np.asarray(counts_sorted[n_zero:], np.int64)
    # group boundaries: up to max_groups distinct count levels (quantiles)
    if pos.size:
        qs = np.quantile(pos, np.linspace(1.0 / max_groups, 1.0, max_groups))
        levels = sorted(set(int(np.ceil(q)) for q in qs) | {int(pos[-1])})
    else:
        levels = []
    # only worth it if the grouped gather count (plus the n_pf-row inverse
    # rank gather) beats the plain (n_pf, k) gather; uniform-nnz instances
    # (e.g. the large config, every column k nonzeros) would only pay the
    # extra rank gather
    grouped_rows = n_pf  # the rt_inv rank gather
    lo = n_zero
    group_spans = []
    for w in levels:
        hi = int(np.searchsorted(counts_sorted, w, side="right"))
        if hi <= lo:
            continue
        group_spans.append((lo, hi, w))
        grouped_rows += (hi - lo) * w
        lo = hi
    assert lo == n_pf, (lo, n_pf)
    if grouped_rows >= 0.9 * n_pf * k:
        return None, None, None, 0
    rt_rows, rt_vals = [], []
    for lo_g, hi_g, w in group_spans:
        sel = order[lo_g:hi_g]  # PF columns in this group (count <= w)
        rt_rows.append(np.ascontiguousarray(rows_pf[sel, :w]))
        rt_vals.append(np.ascontiguousarray(vals_pf[sel, :w]))
    return tuple(rt_rows), tuple(rt_vals), rank.astype(np.int32), n_zero


def _build_ell_row_sharded(rows_pf, vals_pf, num_rows: int, nr: int):
    """Re-encode a PF column-ELL into ``nr`` row shards (both orientations).

    rows_pf/vals_pf: (n_pf, k), zeros on padding; ``num_rows`` must divide
    ``nr`` (caller pads).  Returns (rows3, vals3, mv_cols3, mv_vals3):

      rows3/vals3:     (nr, n_pf, ks) — per-shard column-ELL, LOCAL row ids
      mv_cols3/mv_vals3: (nr, m_loc, kr) — per-shard row-ELL, global PF cols
    """
    n_pf, k = rows_pf.shape
    assert num_rows % nr == 0
    m_loc = num_rows // nr
    nz = vals_pf != 0
    pf_pos = np.broadcast_to(np.arange(n_pf)[:, None], (n_pf, k))[nz].astype(np.int64)
    r = rows_pf[nz].astype(np.int64)
    v = vals_pf[nz]
    shard = r // m_loc
    local_r = (r % m_loc).astype(np.int32)

    from ..native import group_ell

    def ell_by(group_key, dim1, payload_idx, payload_val):
        cols, vals = group_ell(group_key, payload_idx, payload_val, nr * dim1)
        w = cols.shape[1]
        return cols.reshape(nr, dim1, w), vals.reshape(nr, dim1, w)

    # column orientation per shard: group by (shard, pf column)
    rows3, vals3 = ell_by(shard * n_pf + pf_pos, n_pf, local_r, v)
    # row orientation per shard: group by (shard, local row)
    mv_cols3, mv_vals3 = ell_by(shard * m_loc + local_r, m_loc, pf_pos.astype(np.int32), v)
    return rows3, vals3, mv_cols3, mv_vals3


def _build_ell_2d(rows_pf, vals_pf, num_rows: int, nr: int, nc: int):
    """Re-encode a PF column-ELL into an (nr x nc) shard grid — the 2-D
    sharded matvec of SURVEY.md §2b (ring-attention-analog): each device
    owns the (row-shard, col-shard) tile of A, computes its partial of
    both matvecs locally, and the collectives split by axis (A@x psums
    over cols, A^T r psums over rows).

    Returns (rows4, vals4, mv_cols4, mv_vals4):
      rows4/vals4:       (nr, nc, n_loc, ks) — col orientation, LOCAL rows
      mv_cols4/mv_vals4: (nr, nc, m_loc, kr) — row orientation, LOCAL cols
    """
    from ..native import group_ell

    n_pf, k = rows_pf.shape
    assert n_pf % nc == 0 and num_rows % nr == 0
    n_loc, m_loc = n_pf // nc, num_rows // nr
    nz = vals_pf != 0
    pf_pos = np.broadcast_to(np.arange(n_pf)[:, None], (n_pf, k))[nz].astype(np.int64)
    r = rows_pf[nz].astype(np.int64)
    v = vals_pf[nz]
    rshard, local_r = r // m_loc, (r % m_loc).astype(np.int32)
    cshard, local_c = pf_pos // n_loc, (pf_pos % n_loc).astype(np.int32)
    tile = rshard * nc + cshard

    def ell_by(dim2, idx_b, payload):
        cols, vals = group_ell(tile * dim2 + idx_b, payload[0], payload[1],
                               nr * nc * dim2)
        w = cols.shape[1]
        return cols.reshape(nr, nc, dim2, w), vals.reshape(nr, nc, dim2, w)

    rows4, vals4 = ell_by(n_loc, local_c.astype(np.int64), (local_r, v))
    mv_cols4, mv_vals4 = ell_by(m_loc, local_r.astype(np.int64), (local_c, v))
    return rows4, vals4, mv_cols4, mv_vals4


def to_device_matrix(
    M, perm: np.ndarray, dtype=jnp.float32, col_scale=None, n_shards: int = 1,
    row_bucket: bool = False, row_shards: int = 1, _out: Optional[dict] = None,
) -> "DeviceMatrix":
    """Move a host matrix to device with PF column permutation/padding.

    ``col_scale`` (N,) divides each user column (block equilibration).
    ``row_bucket=True`` (unsharded EllMatrix only) permutes rows by nnz
    count into power-of-two width groups — the caller must permute b with
    the ``row_perm`` stashed into ``_out``."""
    # host staging buffers match the requested device precision: staging
    # through float32 would silently quantize a float64 prepare()
    np_dtype = np.dtype(jnp.dtype(dtype).name)
    if np_dtype.kind != "f":
        np_dtype = np.dtype(np.float32)
    sel = perm >= 0
    cs = None if col_scale is None else np.asarray(col_scale)[perm[sel]]
    if isinstance(M, DenseMatrix):
        data = np.zeros((M.shape[0], perm.size), dtype=np_dtype)
        cols = np.asarray(M.data)[:, perm[sel]]
        data[:, sel] = cols if cs is None else cols / cs
        return DeviceDense(data=jnp.asarray(data, dtype=dtype))
    if isinstance(M, EllMatrix):
        rows = np.zeros((perm.size, M.k), dtype=np.int32)
        vals = np.zeros((perm.size, M.k), dtype=np_dtype)
        rows[sel] = np.asarray(M.rows)[perm[sel]]
        v = np.asarray(M.vals)[perm[sel]]
        vals[sel] = v if cs is None else v / cs[:, None]
        if row_shards > 1:
            if M.num_rows % row_shards:
                raise ValueError(
                    f"num_rows={M.num_rows} not divisible by row_shards="
                    f"{row_shards}; pad the instance rows first"
                )
            if n_shards > 1:  # 2-D (row x col) shard grid
                r4, v4, mc4, mv4 = _build_ell_2d(
                    rows, vals, M.num_rows, row_shards, n_shards
                )
                return DeviceEll(
                    rows=jnp.asarray(r4),
                    vals=jnp.asarray(v4, dtype=dtype),
                    mv_cols=jnp.asarray(mc4),
                    mv_vals=jnp.asarray(mv4, dtype=dtype),
                    num_rows=M.num_rows,
                    grid_sharded=True,
                )
            r3, v3, mc3, mv3 = _build_ell_row_sharded(rows, vals, M.num_rows, row_shards)
            return DeviceEll(
                rows=jnp.asarray(r3),
                vals=jnp.asarray(v3, dtype=dtype),
                mv_cols=jnp.asarray(mc3),
                mv_vals=jnp.asarray(mv3, dtype=dtype),
                num_rows=M.num_rows,
                row_sharded=True,
            )
        if row_bucket:
            row_perm, mvc, mvv = _build_row_ell_bucketed(rows, vals, M.num_rows)
            if row_perm is not None:
                rank = np.empty(M.num_rows, np.int64)
                rank[row_perm] = np.arange(M.num_rows)
                rows = rank[rows].astype(np.int32)  # col-ELL in permuted space
                if _out is not None:
                    _out["row_perm"] = row_perm
                rt_r, rt_v, rt_inv, n_zero = _build_col_ell_bucketed(rows, vals)
                return DeviceEll(
                    rows=jnp.asarray(rows),
                    vals=jnp.asarray(vals, dtype=dtype),
                    mv_cols=tuple(jnp.asarray(c) for c in mvc),
                    mv_vals=tuple(jnp.asarray(v2, dtype=dtype) for v2 in mvv),
                    num_rows=M.num_rows,
                    rt_rows=(
                        None if rt_r is None else tuple(jnp.asarray(c) for c in rt_r)
                    ),
                    rt_vals=(
                        None
                        if rt_v is None
                        else tuple(jnp.asarray(v2, dtype=dtype) for v2 in rt_v)
                    ),
                    rt_inv=None if rt_inv is None else jnp.asarray(rt_inv),
                    rt_zeros=n_zero,
                )
        mv_cols, mv_vals = _build_row_ell(rows, vals, M.num_rows, n_shards)
        return DeviceEll(
            rows=jnp.asarray(rows),
            vals=jnp.asarray(vals, dtype=dtype),
            mv_cols=None if mv_cols is None else jnp.asarray(mv_cols),
            mv_vals=None if mv_vals is None else jnp.asarray(mv_vals, dtype=dtype),
            num_rows=M.num_rows,
        )
    if isinstance(M, VStackMatrix):
        scale = 1.0
        bottom = M.bottom
        if isinstance(bottom, ScaledMatrix):
            scale, bottom = bottom.scale, bottom.inner
        # row_shards > 1: row-sharded stacked operator (eq over a tall-A
        # mesh) — EACH part's rows shard over the axis, so device k owns
        # the locally-stacked [top_k; scale*bottom_k] and the caller must
        # interleave b to match (parallel.sharding.interleave_stacked_rows).
        # matvec/rmatvec resolve the top/bottom boundary dynamically
        # (_vstack_top_rows).  CAUTION (row_shards > 1): the same
        # DeviceVStack is VALUE-correct only inside shard_map (local rows)
        # — globally the RHS is shard-major interleaved
        # ([top_0; bot_0; top_1; bot_1; ...]) while matvec concatenates
        # [all-top; all-bottom] and rmatvec slices r[:split] as contiguous
        # top rows, so the global view is SHAPE-consistent only (fine for
        # eval_shape/abstract tracing, wrong for global-view evaluation).
        return DeviceVStack(
            top=to_device_matrix(M.top, perm, dtype, col_scale, n_shards,
                                 row_shards=row_shards),
            bottom=to_device_matrix(bottom, perm, dtype, col_scale, n_shards,
                                    row_shards=row_shards),
            bottom_scale=jnp.asarray(scale, dtype),
            split=M.top.shape[0],
        )
    raise TypeError(f"unsupported host matrix type {type(M)}")


def _col_norms_sq(M) -> np.ndarray:
    """Host-side squared column norms (for equilibration)."""
    if isinstance(M, DenseMatrix):
        return (np.asarray(M.data) ** 2).sum(axis=0)
    if isinstance(M, EllMatrix):
        return (np.asarray(M.vals) ** 2).sum(axis=1)
    if isinstance(M, ScaledMatrix):
        return M.scale**2 * _col_norms_sq(M.inner)
    if isinstance(M, VStackMatrix):
        return _col_norms_sq(M.top) + _col_norms_sq(M.bottom)
    raise TypeError(f"unsupported host matrix type {type(M)}")


def block_scales(problem: Problem) -> np.ndarray:
    """Per-block equilibration scale c_b = RMS column norm of A over the block.

    Solving in u = c_b * x (simplex radius c_b, A columns divided by c_b)
    equalises block curvatures — demand-scaled traffic instances otherwise
    condition the problem by (max demand / min demand)^2.
    """
    part = problem.partition
    cn2 = _col_norms_sq(problem.A)
    sizes = part.sizes
    block_of_col = np.repeat(np.arange(part.num_blocks), sizes)
    sums = np.zeros(part.num_blocks)
    np.add.at(sums, block_of_col, cn2)
    c = np.sqrt(sums / np.maximum(sizes, 1))
    c[c <= 0] = 1.0
    return c


def _prepare_banded(
    problem: Problem, dtype, equilibrate: bool, force: bool,
    fit_threshold: float = 0.6, band_budget_bytes: int = 2 << 30,
    n_shards: int = 1, col_axis: Optional[str] = None,
):
    """Try the banded-split layout (ops/banded.py): re-orders blocks by row
    window, builds per-bucket band tensors + a sparse residual.  Returns
    (DeviceProblem, BlockPartition) — the VALUE-GROUPED partition the caller
    must use for extraction — or (None, None) when the instance is not
    bandable enough (fit fraction below threshold) or the band tensors
    would blow the memory budget; the caller then falls back to the gather
    layout.

    ``n_shards > 1`` shards the band tensors along the
    group axis over ``col_axis``: the ladder page count pads to a multiple
    of n_shards, so every shard owns gl = pages/n_shards contiguous groups
    = a contiguous block range = a contiguous row window.  The residual
    rides the standard column-sharded dual-ELL."""
    from .banded import PAGE, DeviceBanded, build_banded_split

    part = problem.partition
    A0: EllMatrix = problem.A
    # per-block window page: min nonzero row page over the block's columns
    nzmask = np.asarray(A0.vals) != 0
    rows_h = np.asarray(A0.rows)
    col_min = np.where(nzmask, rows_h, np.iinfo(np.int32).max).min(axis=1)
    col_max = np.where(nzmask, rows_h, -1).max(axis=1)
    offsets = np.concatenate([[0], np.cumsum(part.sizes)])[:-1]
    Mp_real = -(-A0.num_rows // PAGE)
    Mp = n_shards * (-(-Mp_real // n_shards))  # pad ladder to the shard count
    block_page = np.clip(
        np.minimum.reduceat(col_min, offsets) // PAGE, 0, Mp_real - 1
    )

    # cheap pre-screens BEFORE building the grouped partition (the full
    # banded attempt costs ~1 s of host work on the standard medium config
    # — don't pay it for instances that can't possibly qualify):
    # (a) nnz-weighted fraction of columns whose row span fits any window
    col_nnz = nzmask.sum(axis=1)
    span_ok = (col_max - col_min) <= 7 * PAGE  # max_pages=8 window
    frac_ok = float(col_nnz[span_ok & (col_nnz > 0)].sum()) / max(col_nnz.sum(), 1)
    if frac_ok < fit_threshold and not force:
        return None, None
    # (b) band memory at the value-grouped inflation (bpp = max page load)
    bpp = int(np.bincount(block_page, minlength=Mp).max())
    est_bytes = Mp * bpp * float(np.mean(part.sizes) + 2) * 1024 * 4
    if est_bytes > band_budget_bytes and not force:
        return None, None

    # value-grouped partition: a block's PF row exactly encodes its window
    # page, so the banded ladder is exact (groups padded to max page load).
    # Capping the load at a quantile (overflow blocks carry forward a page
    # and the window's `back` margin absorbs the shift) trims band memory
    # on medium_banded but widens the effective window of every later page
    # (the carried-forward blocks), which cost a large factor in it/s on
    # the first build's device; so the cap is OFF by default and
    # BSLS_BAND_CAP=<q> opts in when device memory, not throughput, binds.
    cap_env = os.environ.get("BSLS_BAND_CAP", "none")
    cap_q = None if cap_env.lower() == "none" else float(cap_env)
    part2 = BlockPartition.from_sizes(part.sizes, order_key=block_page, groups=Mp,
                                      group_cap_quantile=cap_q)

    # bucket-major perm for the band build (groups ascending per bucket);
    # the DeviceProblem stores the device-major perm when sharded
    perm = build_pf_perm(part2, 1)
    if equilibrate:
        c = block_scales(problem)
        col_scale = np.repeat(c, part.sizes)
    else:
        c = np.ones(part.num_blocks)
        col_scale = None
    np_dtype = np.dtype(jnp.dtype(dtype).name)
    if np_dtype.kind != "f":
        np_dtype = np.dtype(np.float32)
    sel = perm >= 0
    rows_pf = np.zeros((perm.size, A0.k), dtype=np.int32)
    vals_pf = np.zeros((perm.size, A0.k), dtype=np_dtype)
    rows_pf[sel] = np.asarray(A0.rows)[perm[sel]]
    v = np.asarray(A0.vals)[perm[sel]]
    cs = None if col_scale is None else np.asarray(col_scale)[perm[sel]]
    vals_pf[sel] = v if cs is None else v / cs[:, None]

    seg_lens = [b.num_blocks * b.width for b in part2.buckets]
    bands, back, wpages, fit, (res_rows, res_vals) = build_banded_split(
        rows_pf, vals_pf, A0.num_rows, seg_lens, dtype=np_dtype, pages=Mp
    )
    if fit < fit_threshold and not force:
        return None, None

    if n_shards > 1:
        # device-major reindex of the residual/perm: device d's chunk is
        # [bucket0 rows d*L0/n..(d+1)*L0/n, bucket1 rows ..., ...]
        seg_off = np.concatenate([[0], np.cumsum(seg_lens)])
        chunks = [
            np.arange(seg_off[i] + d * (L // n_shards),
                      seg_off[i] + (d + 1) * (L // n_shards))
            for d in range(n_shards)
            for i, L in enumerate(seg_lens)
        ]
        bm_of_dm = np.concatenate(chunks)
        perm = perm[bm_of_dm]
        res_rows = res_rows[bm_of_dm]
        res_vals = res_vals[bm_of_dm]

    if (res_vals != 0).any():
        mv_cols, mv_vals = _build_row_ell(res_rows, res_vals, A0.num_rows, n_shards)
        if n_shards == 1:
            rt_r, rt_v, rt_inv, n_zero = _build_col_ell_bucketed(res_rows, res_vals)
        else:
            # col-nnz bucketing reorders PF columns globally — incompatible
            # with the per-shard leading-axis specs; sharded residual A^T r
            # uses the plain local (n_loc, k) gather
            rt_r = rt_v = rt_inv = None
            n_zero = 0
        resid = DeviceEll(
            rows=jnp.asarray(res_rows),
            vals=jnp.asarray(res_vals, dtype=dtype),
            mv_cols=None if mv_cols is None else jnp.asarray(mv_cols),
            mv_vals=None if mv_vals is None else jnp.asarray(mv_vals, dtype=dtype),
            num_rows=A0.num_rows,
            rt_rows=None if rt_r is None else tuple(jnp.asarray(x) for x in rt_r),
            rt_vals=(
                None if rt_v is None else tuple(jnp.asarray(x, dtype=dtype) for x in rt_v)
            ),
            rt_inv=None if rt_inv is None else jnp.asarray(rt_inv),
            rt_zeros=n_zero,
        )
    else:
        resid = None
    A = DeviceBanded(
        bands=tuple(jnp.asarray(bd, dtype=dtype) for bd in bands),
        resid=resid,
        num_rows=A0.num_rows,
        wpages=wpages,
        back=back,
        n_pf=int(perm.size),
        seg_lens=tuple(seg_lens),
        pages=Mp,
        n_shards=n_shards,
        col_axis=col_axis if n_shards > 1 else None,
    )
    buckets = tuple(
        DeviceBucket(
            mask=jnp.asarray(b.mask, dtype=dtype),
            sizes=jnp.asarray(b.sizes, dtype=jnp.int32),
            radius=jnp.asarray(
                np.where(b.block_ids >= 0, c[np.maximum(b.block_ids, 0)], 1.0),
                dtype=dtype,
            ),
            width=b.width,
        )
        for b in part2.buckets
    )
    return DeviceProblem(
        A=A,
        b=jnp.asarray(np.asarray(problem.b), dtype=dtype),
        buckets=buckets,
        perm=jnp.asarray(perm),
        n_user=part.n_flat,
        num_rows=A0.num_rows,
        col_axis=col_axis if n_shards > 1 else None,
    ), part2


def prepare(
    problem: Problem,
    dtype=jnp.float32,
    n_shards: int = 1,
    col_axis: Optional[str] = None,
    row_axis: Optional[str] = None,
    equilibrate: bool = True,
    row_shards: int = 1,
    layout: str = "auto",  # auto | banded | gather
    reduce_axis: Optional[str] = None,  # deprecated alias for col_axis
    _out: Optional[dict] = None,
) -> DeviceProblem:
    """Move a host Problem into the device-side PF layout.

    ``n_shards > 1`` lays A's columns out device-major for a block-sharded
    mesh (see bsls_tpu.parallel.sharding); the single-device layout is the
    n_shards=1 special case of the same path.

    When the banded layout is selected, the value-grouped partition it
    solves under is stashed in ``_out['partition']`` (the caller's
    extraction must use it — the banded path re-orders and re-pads blocks).
    """
    # banded x scenario cross-over: the band tensors stream the same bytes
    # per iteration regardless of S, while scenario batching amortises the
    # gather layout's random-row cost — so under layout="auto" large
    # scenario batches keep the gather layout.  The S < 16 crossover was
    # tuned on the first build's device and is due for re-measurement.
    # layout="banded" still forces the band path at any S.
    num_scenarios = (
        int(np.asarray(problem.b).shape[0]) if np.asarray(problem.b).ndim == 2 else 1
    )
    if (
        (layout == "banded" or (layout == "auto" and num_scenarios < 16))
        and row_shards == 1
        and not row_axis
        and (n_shards == 1 or (col_axis or reduce_axis))
        and isinstance(problem.A, EllMatrix)
    ):
        dp, part2 = _prepare_banded(
            problem, dtype, equilibrate, force=(layout == "banded"),
            n_shards=n_shards, col_axis=col_axis or reduce_axis,
        )
        if dp is not None:
            if _out is not None:
                _out["partition"] = part2
            return dp
    elif layout == "banded":
        raise ValueError(
            "layout='banded' requires an EllMatrix instance and column "
            "(block) or no sharding — row sharding has no banded form"
        )
    part = problem.partition
    perm = build_pf_perm(part, n_shards)
    if equilibrate:
        c = block_scales(problem)
        col_scale = np.repeat(c, part.sizes)
    else:
        c = np.ones(part.num_blocks)
        col_scale = None
    buckets = tuple(
        DeviceBucket(
            mask=jnp.asarray(b.mask, dtype=dtype),
            sizes=jnp.asarray(b.sizes, dtype=jnp.int32),
            radius=jnp.asarray(
                np.where(b.block_ids >= 0, c[np.maximum(b.block_ids, 0)], 1.0), dtype=dtype
            ),
            width=b.width,
        )
        for b in part.buckets
    )
    # row-nnz bucketing: only for unsharded plain-ELL problems (sharded
    # layouts slice mv arrays by a leading shard axis; VStack splits assume
    # the original row order of each part)
    row_bucket = (
        n_shards == 1
        and not (col_axis or reduce_axis or row_axis)
        and isinstance(problem.A, EllMatrix)
    )
    out_info: dict = {}
    A = to_device_matrix(
        problem.A, perm, dtype, col_scale, n_shards, row_bucket=row_bucket,
        row_shards=row_shards, _out=out_info,
    )
    b = np.asarray(problem.b)
    if "row_perm" in out_info:
        b = b[..., out_info["row_perm"]]
    return DeviceProblem(
        A=A,
        b=jnp.asarray(b, dtype=dtype),
        buckets=buckets,
        perm=jnp.asarray(perm),
        n_user=part.n_flat,
        num_rows=problem.A.shape[0],
        col_axis=col_axis or reduce_axis,
        row_axis=row_axis,
        row_perm=(
            jnp.asarray(out_info["row_perm"], jnp.int32)
            if "row_perm" in out_info
            else None
        ),
    )


# ---------------- layout conversions (device, shape-driven) ----------------


def padded_to_flat(dp: DeviceProblem, xp) -> jnp.ndarray:
    """Padded buckets -> PF flat vector: pure reshape/concat (zero-copy-ish)."""
    parts = [x.reshape(*x.shape[:-2], -1) for x in xp]
    return parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=-1)


def flat_to_padded(dp: DeviceProblem, x_flat: jnp.ndarray):
    """PF flat vector -> padded buckets: split + reshape.

    Shape-driven from the bucket masks, so it works unchanged on shard-local
    views inside shard_map.
    """
    out = []
    off = 0
    lead = x_flat.shape[:-1]
    for bk in dp.buckets:
        rows, w = bk.mask.shape
        size = rows * w
        seg = jax.lax.dynamic_slice_in_dim(x_flat, off, size, axis=-1)
        out.append(seg.reshape(*lead, rows, w))
        off += size
    return tuple(out)


def extract_user_flat(dp: DeviceProblem, xp) -> jnp.ndarray:
    """Map padded buckets back to the user's flat ordering (N,), undoing the
    equilibration scaling (u -> x = u / c_b).  Not a hot-path op — used once
    at result extraction (single-device path only)."""
    xs = tuple(
        x / jnp.maximum(bk.radius, 1e-30)[:, None] for x, bk in zip(xp, dp.buckets)
    )
    x_pf = padded_to_flat(dp, xs)
    sel = dp.perm >= 0
    idx = jnp.where(sel, dp.perm, 0)
    if x_pf.ndim == 1:
        return jnp.zeros((dp.n_user,), x_pf.dtype).at[idx].add(jnp.where(sel, x_pf, 0))
    # leading scenario axis
    S = x_pf.shape[0]
    return (
        jnp.zeros((S, dp.n_user), x_pf.dtype)
        .at[:, idx]
        .add(jnp.where(sel[None, :], x_pf, 0))
    )


# ---------------- matvec ----------------

# Single-RHS sparse matvec is gather-bound: one random-access row per
# nonzero.  The framework's lever is scenario batching: vmapping the solver
# over S RHS turns each gathered element into a width-S row, amortising the
# random access over the batch.  The chunk bound below was set on the first
# build's device and is due for re-measurement.
_GATHER_CHUNK_ELEMS = 4 * 1024 * 1024


def gather_dot(vals: jnp.ndarray, idx: jnp.ndarray, vec: jnp.ndarray) -> jnp.ndarray:
    """sum(vals * vec[idx], axis=-1) for (rows, k) vals/idx.

    For very large rows*k (the 1M-block config has 48M nonzeros) the fused
    gather would materialise an (rows, k[, S]) buffer that blows device
    memory under scenario-vmap; chunk sequentially over row segments with
    lax.map to bound peak memory."""
    rows, k = idx.shape
    total = rows * k
    if total <= _GATHER_CHUNK_ELEMS:
        return jnp.sum(vals * vec[idx], axis=-1)
    nseg = 1
    while total // nseg > _GATHER_CHUNK_ELEMS and nseg < rows:
        nseg *= 2
    while nseg > 1 and rows % nseg:
        nseg //= 2
    if nseg <= 1:
        return jnp.sum(vals * vec[idx], axis=-1)
    c = idx.reshape(nseg, rows // nseg, k)
    v = vals.reshape(nseg, rows // nseg, k)
    y = jax.lax.map(lambda cv: jnp.sum(cv[1] * vec[cv[0]], axis=-1), (c, v))
    return y.reshape(rows)


def _vstack_top_rows(A: "DeviceVStack") -> int:
    """Rows contributed by the top part of a DeviceVStack in the CURRENT
    view.  Dense tops read their (possibly shard-sliced) data shape and
    row-sharded ELL tops their (n_shards, m_loc) encoding, so the boundary
    is local inside shard_map and global outside — the static ``split``
    only covers the plain (unsharded-rows) ELL encodings, whose arrays
    don't carry a row count."""
    t = A.top
    if isinstance(t, DeviceDense):
        return t.data.shape[0]
    if getattr(t, "row_sharded", False):
        return t.mv_cols.shape[0] * t.mv_cols.shape[1]
    return A.split


def matvec(A: DeviceMatrix, x: jnp.ndarray) -> jnp.ndarray:
    """A @ x for PF flat x (shard-local partial result when sharded)."""
    from .banded import DeviceBanded, banded_matvec

    if isinstance(A, DeviceBanded):
        y = banded_matvec(A, x)
        return y if A.resid is None else y + matvec(A.resid, x)
    if isinstance(A, DeviceDense):
        # HIGHEST: at default precision a float32 product may run in TF32
        # on the tensor cores (~1e-3 relative), which stalls 1e-6
        # convergence; under scenario vmap this is a real matmul.
        return jnp.einsum("mn,n->m", A.data, x,
                          precision=jax.lax.Precision.HIGHEST)
    if isinstance(A, DeviceVStack):
        return jnp.concatenate([matvec(A.top, x), A.bottom_scale * matvec(A.bottom, x)])
    if A.grid_sharded:
        # (row, col) tile: local partial over this tile's rows from this
        # col shard's x; matvec_ps psums over the col axis.  Global view
        # (testing): sum over col shards, concat over row shards.
        nr, nc = A.mv_cols.shape[:2]
        if nr == 1 and nc == 1:
            return gather_dot(A.mv_vals[0, 0], A.mv_cols[0, 0], x)
        n_loc = x.shape[-1] // nc
        parts = []
        for rsh in range(nr):
            y = sum(
                gather_dot(
                    A.mv_vals[rsh, c], A.mv_cols[rsh, c],
                    x[..., c * n_loc : (c + 1) * n_loc],
                )
                for c in range(nc)
            )
            parts.append(y)
        return jnp.concatenate(parts, axis=-1)
    if A.row_sharded:
        # x replicated; each shard produces its own local row segment.  A
        # global (nr>1) view concatenates the segments (full-m result).
        nr = A.mv_cols.shape[0]
        if nr == 1:
            return gather_dot(A.mv_vals[0], A.mv_cols[0], x)
        parts = [gather_dot(A.mv_vals[s], A.mv_cols[s], x) for s in range(nr)]
        return jnp.concatenate(parts)
    if isinstance(A.mv_cols, tuple):
        # row-nnz-bucketed: per-width partials concatenate contiguously in
        # the (nnz-sorted) permuted row order — no scatter, minimal rows
        parts = [gather_dot(v, c, x) for c, v in zip(A.mv_cols, A.mv_vals)]
        return parts[0] if len(parts) == 1 else jnp.concatenate(parts)
    if A.mv_cols is not None:
        # Inside shard_map the leading dim is 1 (one local shard); on a
        # global view it is n_shards and the partials sum with local->global
        # column offsets.
        ns, m, kr = A.mv_cols.shape
        if ns == 1:
            return gather_dot(A.mv_vals[0], A.mv_cols[0], x)
        n_loc = x.shape[-1] // ns
        offs = (jnp.arange(ns) * n_loc)[:, None, None]
        return jnp.sum(A.mv_vals * x[A.mv_cols + offs], axis=(0, -1))
    contrib = A.vals * x[:, None]  # (n, k)
    return jax.ops.segment_sum(
        contrib.reshape(-1), A.rows.reshape(-1), num_segments=A.num_rows
    )


def rmatvec(A: DeviceMatrix, r: jnp.ndarray) -> jnp.ndarray:
    """A^T @ r -> PF flat.  Column-sharded: r replicated, result local.
    Row-sharded: r is this shard's local segment; the partial A_s^T r_s
    psums over the row axis (rmatvec_ps)."""
    from .banded import DeviceBanded, banded_rmatvec

    if isinstance(A, DeviceBanded):
        g = banded_rmatvec(A, r)
        return g if A.resid is None else g + rmatvec(A.resid, r)
    if isinstance(A, DeviceDense):
        return jnp.einsum("mn,m->n", A.data, r,  # HIGHEST: see matvec note
                          precision=jax.lax.Precision.HIGHEST)
    if isinstance(A, DeviceVStack):
        split = _vstack_top_rows(A)
        return rmatvec(A.top, r[:split]) + A.bottom_scale * rmatvec(A.bottom, r[split:])
    if A.grid_sharded:
        nr, nc = A.rows.shape[:2]
        if nr == 1 and nc == 1:
            return gather_dot(A.vals[0, 0], A.rows[0, 0], r)
        m_loc = r.shape[-1] // nr
        outs = []
        for c in range(nc):
            g = sum(
                gather_dot(
                    A.vals[rsh, c], A.rows[rsh, c],
                    r[..., rsh * m_loc : (rsh + 1) * m_loc],
                )
                for rsh in range(nr)
            )
            outs.append(g)
        return jnp.concatenate(outs, axis=-1)
    if A.row_sharded:
        nr = A.rows.shape[0]
        if nr == 1:
            return gather_dot(A.vals[0], A.rows[0], r)
        # global view: r is the full (m,) vector; sum per-shard partials
        m_loc = r.shape[-1] // nr
        rs = r.reshape(*r.shape[:-1], nr, m_loc)
        return sum(
            gather_dot(A.vals[s], A.rows[s], rs[..., s, :]) for s in range(nr)
        )
    if A.rt_rows is not None:
        # col-nnz-bucketed: gather only real nonzeros (grouped widths),
        # zero-nnz columns emitted directly, one rank gather to PF order
        parts = [gather_dot(v, rw, r) for rw, v in zip(A.rt_rows, A.rt_vals)]
        if A.rt_zeros:
            z = jnp.zeros((A.rt_zeros,), parts[0].dtype if parts else r.dtype)
            parts = [z] + parts
        g_sorted = parts[0] if len(parts) == 1 else jnp.concatenate(parts)
        return g_sorted[A.rt_inv]
    return gather_dot(A.vals, A.rows, r)


def psum_if_sharded(dp: DeviceProblem, v):
    return jax.lax.psum(v, dp.col_axis) if dp.col_axis else v


def matvec_ps(dp: DeviceProblem, x: jnp.ndarray) -> jnp.ndarray:
    """A @ x assembled across the column (block) shards: local partial +
    psum over col_axis.  Under row sharding the result is this device's row
    segment of r (no collective needed).  THE residual collective of the
    sharded step (SURVEY.md §3e)."""
    y = matvec(dp.A, x)
    return jax.lax.psum(y, dp.col_axis) if dp.col_axis else y


def rmatvec_ps(dp: DeviceProblem, r: jnp.ndarray) -> jnp.ndarray:
    """A^T @ r assembled across the row shards: local partial + psum over
    row_axis.  Under column-only sharding it is block-local (r replicated)."""
    g = rmatvec(dp.A, r)
    return jax.lax.psum(g, dp.row_axis) if dp.row_axis else g


def xdot(dp: DeviceProblem, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Inner product of x-space (PF / bucket-flat, column-sharded) vectors."""
    s = jnp.vdot(a, b).real
    return jax.lax.psum(s, dp.col_axis) if dp.col_axis else s


def rdot(dp: DeviceProblem, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Inner product of r-space (row-sharded) vectors."""
    s = jnp.vdot(a, b).real
    return jax.lax.psum(s, dp.row_axis) if dp.row_axis else s


def xmatdot(dp: DeviceProblem, M: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Batched x-space dots: (K, n_pf) @ (n_pf,) -> (K,), psummed over the
    column shards like xdot.  One fused reduction instead of K serial dots
    (the L-BFGS compact form's history products).  HIGHEST: at default
    precision the contraction may run in TF32 (~1e-3 relative), which
    breaks 1e-6 convergence."""
    s = jnp.einsum("kn,n->k", M, v, precision=jax.lax.Precision.HIGHEST)
    return jax.lax.psum(s, dp.col_axis) if dp.col_axis else s


# back-compat name used throughout the solvers for x-space dots
pvdot = xdot


# ---------------- small helpers ----------------


def inject_user_grad(dp: DeviceProblem, g_user: jnp.ndarray) -> jnp.ndarray:
    """User-flat GRADIENT -> PF flat in the equilibrated coordinates.

    The device solves in u = c_b * x (block equilibration), so gradients
    transform inversely: g_dev = g_user / c_b.  Used by the iterative-
    refinement anchor (solvers/base.py solve(refine=K))."""
    rad_p = tuple(
        jnp.broadcast_to(bk.radius[:, None], bk.mask.shape) * bk.mask for bk in dp.buckets
    )
    scale_pf = padded_to_flat(dp, rad_p)
    sel = dp.perm >= 0
    return jnp.where(
        sel, g_user[jnp.maximum(dp.perm, 0)] / jnp.maximum(scale_pf, 1e-30), 0.0
    )


def inject_user_flat(dp: DeviceProblem, x_user: jnp.ndarray):
    """Inverse of extract_user_flat: user-flat x -> padded equilibrated
    buckets (u = c_b * x).  Used for warm starts."""
    rad_p = tuple(
        jnp.broadcast_to(bk.radius[:, None], bk.mask.shape) * bk.mask for bk in dp.buckets
    )
    scale_pf = padded_to_flat(dp, rad_p)
    sel = dp.perm >= 0
    u_pf = jnp.where(sel, x_user[jnp.maximum(dp.perm, 0)] * scale_pf, 0.0)
    return flat_to_padded(dp, u_pf)


def feasible_init(dp: DeviceProblem, dtype=None):
    """Uniform feasible start: radius/n_i on each real block, 0 on padding."""
    xp = []
    for bk in dp.buckets:
        d = dtype or bk.mask.dtype
        inv = jnp.where(
            bk.sizes > 0, bk.radius / jnp.maximum(bk.sizes, 1).astype(d), 0.0
        )
        xp.append(bk.mask.astype(d) * inv[:, None])
    return tuple(xp)
