"""Block partition: bucketing, padding and flat<->padded index maps.

The decision variable ``x`` is a concatenation of B simplex blocks of sizes
``n_1..n_B`` (flat length N = sum n_i).  On the device all per-block kernels
(projection, PAVA, EG renormalise, FW vertex) want a *rectangular* layout, so
blocks are bucketed by padded width into a few ``(B_k, w_k)`` arrays:

  * every block is assigned to the smallest bucket width >= its size,
  * within a bucket, rows are real blocks (possibly followed by all-padding
    dummy rows so ``B_k`` is a multiple of ``block_multiple`` — used to make
    the bucket shardable over the 'block' mesh axis),
  * ``pad_to_flat[(bk, j)]`` maps each padded slot to its flat index in ``x``
    (0 for padding slots, which are masked out everywhere).

The reference keeps a plain ``block_sizes`` int vector and loops in C
(SURVEY.md §2 #2/#4, provenance [UNVERIFIED] — reference mount was empty);
this module is the device-side replacement that makes every per-block op a
dense rectangular vmap/kernel.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

__all__ = ["Bucket", "BlockPartition", "default_bucket_widths"]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def default_bucket_widths(sizes: np.ndarray, max_buckets: int = 4) -> list[int]:
    """Choose bucket widths: powers of two covering the size distribution.

    Keeps padding waste bounded (<2x within a bucket) with at most
    ``max_buckets`` distinct rectangle shapes (so at most that many compiled
    kernel variants).
    """
    mx = int(np.max(sizes))
    widths: list[int] = []
    w = 2
    while w < mx:
        widths.append(w)
        w *= 2
    widths.append(max(2, mx))
    # keep the top ``max_buckets`` widths; everything smaller folds upward
    widths = sorted(set(widths))[-max_buckets:]
    return widths


@dataclass(frozen=True)
class Bucket:
    """One rectangular group of equally padded blocks."""

    width: int  # padded block width w_k (>= every member's size)
    block_ids: np.ndarray  # (B_k,) global block index; -1 for dummy rows
    sizes: np.ndarray  # (B_k,) true block sizes; 0 for dummy rows
    pad_to_flat: np.ndarray  # (B_k, width) int32 flat index; 0 where invalid

    @property
    def num_blocks(self) -> int:
        return int(self.sizes.shape[0])

    @cached_property
    def mask(self) -> np.ndarray:
        """(B_k, width) float32: 1.0 for real slots, 0.0 for padding."""
        cols = np.arange(self.width)[None, :]
        return (cols < self.sizes[:, None]).astype(np.float32)

    @cached_property
    def row_valid(self) -> np.ndarray:
        """(B_k,) float32: 1.0 for real blocks, 0.0 for dummy rows."""
        return (self.sizes > 0).astype(np.float32)


@dataclass(frozen=True)
class BlockPartition:
    """Bucketed, padded view of a blocked variable of flat length ``n_flat``."""

    sizes: np.ndarray  # (B,) original block sizes
    buckets: tuple[Bucket, ...]
    n_flat: int

    @property
    def num_blocks(self) -> int:
        return int(self.sizes.shape[0])

    @cached_property
    def padded_size(self) -> int:
        return sum(b.num_blocks * b.width for b in self.buckets)

    @staticmethod
    def from_sizes(
        sizes,
        bucket_widths: list[int] | None = None,
        block_multiple: int = 1,
        max_buckets: int = 4,
        order_key=None,
        groups: int | None = None,
        group_cap_quantile: float | None = None,
    ) -> "BlockPartition":
        """``order_key``: optional (B,) array; blocks within each bucket are
        sorted by it (stable).  Used by the banded layout to order blocks by
        row window so PF position tracks the band (ops/banded.py); block
        order is otherwise arbitrary — extraction maps through pad_to_flat.

        ``groups``: with order_key, treat order_key as a GROUP ID in
        [0, groups) (clipped): each bucket lays group g's blocks at rows
        [g*bpp, g*bpp + count_g), bpp = max group load, padding every group
        to bpp with dummy rows — so a block's row position exactly encodes
        its group.  The banded layout passes groups = number of 128-row
        pages and key = each block's window page; tail-only padding or
        quantile-balanced groups would let the static ladder drift off the
        band by the local density fluctuation (~m/sqrt(B) rows).

        ``group_cap_quantile``: with groups, cap each group's load at that
        quantile of the nonzero loads and carry overflow blocks FORWARD to
        the next group with spare capacity (never backward, so a carried
        block's rows sit at most a few pages behind its assigned ladder
        page — the banded window's ``back`` margin absorbs the shift, and
        columns shifted too far spill to the gather residual).  This caps
        the bands-per-page padding inflation: every group pads to the max
        load, so one dense page would otherwise inflate EVERY group's
        memory."""
        sizes = np.asarray(sizes, dtype=np.int64)
        if sizes.ndim != 1 or sizes.size == 0:
            raise ValueError("sizes must be a non-empty 1-D array")
        if np.any(sizes < 1):
            raise ValueError("all block sizes must be >= 1")
        if bucket_widths is None:
            if np.all(sizes == sizes[0]):
                bucket_widths = [int(sizes[0])]
            else:
                bucket_widths = default_bucket_widths(sizes, max_buckets)
        bucket_widths = sorted(bucket_widths)
        if int(sizes.max()) > bucket_widths[-1]:
            raise ValueError(
                f"largest bucket width {bucket_widths[-1]} < max block size {sizes.max()}"
            )

        offsets = np.concatenate([[0], np.cumsum(sizes)])
        n_flat = int(offsets[-1])
        # assign each block to the smallest width >= its size
        widths_arr = np.asarray(bucket_widths)
        assign = np.searchsorted(widths_arr, sizes, side="left")

        buckets: list[Bucket] = []
        for k, w in enumerate(bucket_widths):
            ids = np.nonzero(assign == k)[0]
            if ids.size == 0:
                continue
            if order_key is not None:
                ids = ids[np.argsort(np.asarray(order_key)[ids], kind="stable")]
            if groups and order_key is not None:
                # value-grouped layout: order_key IS the group id (clipped);
                # each group's blocks sit at rows [g*bpp, g*bpp + count_g),
                # bpp = max group load, remaining rows are dummies.  Row
                # position is then an exact, data-independent function of
                # the group — what the banded layout's static ladder needs.
                gid = np.clip(np.asarray(order_key)[ids].astype(np.int64), 0, groups - 1)
                counts = np.bincount(gid, minlength=groups)
                if group_cap_quantile is not None and counts.max() > 0:
                    nzc = counts[counts > 0]
                    cap = max(int(np.ceil(np.quantile(nzc, group_cap_quantile))), 1)
                    if counts.max() > cap:
                        # forward-carry levelling sweep (O(groups))
                        new_counts = np.zeros_like(counts)
                        carry = 0
                        for g in range(groups):
                            load = int(counts[g]) + carry
                            take = min(load, cap)
                            new_counts[g] = take
                            carry = load - take
                        if carry:  # tail overflow: last group absorbs it
                            new_counts[groups - 1] += carry
                        # ids are sorted by gid (stable); reassignment
                        # preserves order, so block i's new group is just
                        # the repeat expansion — forward-only by induction
                        # (cumulative new counts never exceed cumulative
                        # old counts)
                        gid = np.repeat(np.arange(groups, dtype=np.int64),
                                        new_counts)
                        counts = new_counts
                bpp = max(int(counts.max()), 1)
                bk = _round_up(groups * bpp, block_multiple)
                row_of = np.full(bk, -1, dtype=np.int64)  # index into ids
                # ids sorted by gid (stable): place group runs at g*bpp
                starts_g = np.concatenate([[0], np.cumsum(counts)])[:-1]
                pos_in_g = np.arange(ids.size) - starts_g[gid]
                row_of[gid * bpp + pos_in_g] = np.arange(ids.size)
                real_rows = row_of >= 0
                id_at = np.where(real_rows, ids[np.maximum(row_of, 0)], -1)
            else:
                bk = _round_up(ids.size, block_multiple)
                id_at = np.full(bk, -1, dtype=np.int64)
                id_at[: ids.size] = ids
                real_rows = id_at >= 0
            block_ids = id_at
            bsz = np.where(real_rows, sizes[np.maximum(id_at, 0)], 0)
            p2f = np.zeros((bk, w), dtype=np.int32)
            cols = np.arange(w)[None, :]
            starts = offsets[np.maximum(id_at, 0)][:, None]
            real = (cols < bsz[:, None]) & real_rows[:, None]
            p2f = np.where(real, starts + cols, 0).astype(np.int32)
            buckets.append(Bucket(width=int(w), block_ids=block_ids, sizes=bsz, pad_to_flat=p2f))
        return BlockPartition(sizes=sizes, buckets=tuple(buckets), n_flat=n_flat)

    @staticmethod
    def uniform(num_blocks: int, dim: int, block_multiple: int = 1) -> "BlockPartition":
        return BlockPartition.from_sizes(
            np.full(num_blocks, dim, dtype=np.int64), block_multiple=block_multiple
        )

    # ---- numpy-side layout conversions (device-side live in ops/layout.py) ----

    def flat_to_padded_np(self, x_flat: np.ndarray) -> list[np.ndarray]:
        """Gather a flat (N,)-vector into per-bucket (B_k, w_k) padded arrays."""
        x_flat = np.asarray(x_flat)
        out = []
        for b in self.buckets:
            xp = x_flat[b.pad_to_flat] * b.mask.astype(x_flat.dtype)
            out.append(xp)
        return out

    def padded_to_flat_np(self, xp_list) -> np.ndarray:
        """Scatter per-bucket padded arrays back into a flat (N,) vector."""
        dtype = np.asarray(xp_list[0]).dtype
        out = np.zeros(self.n_flat, dtype=dtype)
        for b, xp in zip(self.buckets, xp_list):
            m = b.mask.astype(bool)
            out[b.pad_to_flat[m]] = np.asarray(xp)[m]
        return out
