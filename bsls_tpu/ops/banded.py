"""Structure-adaptive banded-split layout: gather-free sparse matvec for
bandable instances.

The uniform-random benchmark instances are an adversarial worst case for
ANY layout — every nonzero forces one random-access gathered row.  Real
route-incidence
matrices are different: routes traverse spatially local links, so after a
bandwidth-reducing ordering (RCM on the bipartite adjacency; models/
reorder.py) each column's nonzero rows fall in a narrow window that
advances with the column index.  This module exploits that with a layout
whose hot loop contains NO gathers and NO scatters:

  * rows are padded to Mp = ceil(m/128) pages of 128;
  * within each width bucket, blocks are sorted by their row window
    (models/partition.py order_key), so PF position correlates with the
    window;  each bucket's PF range is cut into Mp equal column groups
    (C_b = ceil(L_b/Mp)), group g owning the static window
    [128*g, 128*(g + wpages));
  * columns whose nonzeros fit their group window are stored DENSE in a
    per-bucket band tensor (Mp, C_b, Wmax); the rest go to a small
    residual dual-ELL.

Per iteration the banded part is pure dense algebra:

    A@x  : Z_b = einsum('gcw,gc->gw', band_b, x_b)   per bucket, summed;
           y  = sum_j pad_shift(Z[:, j*128:(j+1)*128], j pages)
           (wpages static shifted adds — the overlap-add of a block-
           bidiagonal matrix)
    A^T r: Rw = hstack(r_pages[j : j+Mp] for j < wpages)   (static slices)
           g_b = einsum('gcw,gw->gc', band_b, Rw)

i.e. speed-of-light = band-tensor stream bandwidth, not the gather floor.
The residual rides the existing gather path.  Profitability is decided at
prepare time from the measured fit fraction and band memory.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["DeviceBanded", "build_banded_split", "banded_matvec", "banded_rmatvec"]

PAGE = 128


@dataclass(frozen=True)
class DeviceBanded:
    """Banded-split device matrix.  ``bands[b]`` is (Mp, C_b, Wmax) for
    bucket b whose PF range is [offsets[b], offsets[b] + Mp*C_b) after
    zero-padding; ``resid`` holds non-fitting nonzeros (or None).

    Group g's window covers logical row pages [g - back, g - back + wpages)
    — in the front-padded page coordinate system used by the matvecs, the
    window of group g always starts at padded page g, which is what keeps
    every slice static.

    Block sharding: with ``n_shards > 1`` the band tensors
    shard along the GROUP axis (axis 0) over ``col_axis`` — in the
    value-grouped layout groups are contiguous block ranges, so a group
    shard is exactly a block shard, and shard d's matvec contribution is
    the contiguous row window [d*gl - back, (d+1)*gl + wpages - back)
    pages, placed by one dynamic_update_slice into the zero residual and
    assembled by the SAME length-m psum the gather layout uses.  Inside
    shard_map the local band has gl = pages/n_shards groups (< ``pages``,
    which is how the matvecs detect the local view); a global (full-shape)
    view evaluates as n_shards sequential shard computations against the
    device-major PF vector."""

    bands: tuple  # tuple[(Mp, C_b, Wmax) f32]
    resid: Optional[object]  # DeviceEll or None
    num_rows: int  # static: original m
    wpages: int  # static: window width in pages
    back: int  # static: pages the window extends BEHIND the ladder page
    n_pf: int  # static
    seg_lens: tuple  # static: unpadded PF length per bucket segment
    pages: int = 0  # static: GLOBAL (shard-padded) ladder page count; 0 =
    # derive from bands[0].shape[0] (unsharded back-compat)
    n_shards: int = 1  # static: block shards of the group axis
    col_axis: Optional[str] = None  # static: mesh axis of the shards


def _register():
    jax.tree_util.register_dataclass(
        DeviceBanded,
        data_fields=["bands", "resid"],
        meta_fields=["num_rows", "wpages", "back", "n_pf", "seg_lens",
                     "pages", "n_shards", "col_axis"],
    )


_register()


def _global_pages(A: DeviceBanded) -> int:
    return A.pages if A.pages else A.bands[0].shape[0]


def block_window_key(rows_pf: np.ndarray, vals_pf: np.ndarray) -> np.ndarray:
    """Per-PF-column window key (min nonzero row; big for empty columns)."""
    nz = vals_pf != 0
    r = np.where(nz, rows_pf, np.iinfo(np.int32).max)
    return r.min(axis=1)


def _choose_window(rows_pf, vals_pf, seg_lens, Mp, max_pages,
                   min_fit: float = 0.5,
                   gather_bytes: float = 4914.0):
    """Cost-model window choice.

    Band bytes scale linearly with the window width (the (Mp, C_b, W)
    tensors keep a slot for every column whether or not it fits), while a
    spilled column only costs its nonzeros' gathered rows.  So instead of a
    fixed percentile cut, enumerate candidate (back, end) pairs from the
    per-column page-delta quantiles and pick the one minimising the modeled
    per-iteration cost, in bytes of band streaming,

        2 * band_bytes(wpages)  +  2 * nnz_spilled * gather_bytes

    where ``gather_bytes`` prices one random gathered row as that many
    streamed bytes (the ratio measured on the first build's device; due
    for re-measurement on the current one).  Both the matvec and the
    rmatvec stream the band once and gather the residual once.  Candidates whose nnz fit-fraction drops below
    ``min_fit`` are skipped so the layout stays recognisably banded; the
    2nd..98th percentile window is the fallback when nothing qualifies."""
    deltas_lo, deltas_hi, nnzs = [], [], []
    nz = vals_pf != 0
    off = 0
    for L in seg_lens:
        C = max(-(-L // Mp), 1)
        pos = np.arange(L)
        g = pos // C
        seg_nz = nz[off : off + L]
        r = rows_pf[off : off + L]
        rmin = np.where(seg_nz, r, np.iinfo(np.int32).max).min(axis=1)
        rmax = np.where(seg_nz, r, -1).max(axis=1)
        valid = rmax >= 0
        deltas_lo.append(rmin[valid] // PAGE - g[valid])
        deltas_hi.append(rmax[valid] // PAGE - g[valid])
        nnzs.append(seg_nz.sum(axis=1)[valid])
        off += L
    dlo = np.concatenate(deltas_lo) if deltas_lo else np.zeros(1, np.int64)
    dhi = np.concatenate(deltas_hi) if deltas_hi else np.zeros(1, np.int64)
    colnnz = np.concatenate(nnzs) if nnzs else np.zeros(1, np.int64)
    nnz_total = max(int(colnnz.sum()), 1)

    # fallback: percentile window (the pre-cost-model behaviour)
    fb_back = int(np.clip(-np.percentile(dlo, 2), 0, max_pages - 1))
    fb_end = int(np.clip(np.percentile(dhi, 98) + 1, 1 - fb_back, max_pages - fb_back))
    fallback = (fb_back, max(fb_back + fb_end, 1))

    # band bytes per page of window width (fixed by the segment shapes)
    bytes_per_wpage = sum(Mp * max(-(-L // Mp), 1) for L in seg_lens) * PAGE * 4

    qs = (0, 0.5, 1, 2, 5, 10, 25, 50)
    backs = sorted({int(np.clip(-np.percentile(dlo, q), 0, max_pages - 1)) for q in qs})
    ends = sorted({int(np.clip(np.percentile(dhi, 100 - q) + 1, 1, max_pages)) for q in qs})
    best = None
    for ba in backs:
        for en in ends:
            wp = ba + en
            if wp < 1 or wp > max_pages:
                continue
            spilled = (dlo < -ba) | (dhi > en - 1)
            nnz_spill = int(colnnz[spilled].sum())
            if 1.0 - nnz_spill / nnz_total < min_fit:
                continue
            cost = 2.0 * bytes_per_wpage * wp + 2.0 * nnz_spill * gather_bytes
            if best is None or cost < best[0]:
                best = (cost, ba, wp)
    if best is None:
        return fallback
    return best[1], best[2]


def build_banded_split(
    rows_pf: np.ndarray,
    vals_pf: np.ndarray,
    num_rows: int,
    seg_lens: list[int],
    max_pages: int = 8,
    dtype=np.float32,
    pages: int = 0,
):
    """Build the banded split from PF column-ELL data.

    ``seg_lens``: PF length of each bucket segment (concatenated = n_pf).
    ``pages`` overrides the ladder page count (block sharding pads it to a
    multiple of the shard count; extra groups are empty).
    Returns (bands, back, wpages, fit_fraction, (resid_rows, resid_vals)).
    """
    n_pf, k = rows_pf.shape
    assert sum(seg_lens) == n_pf
    Mp = pages if pages else -(-num_rows // PAGE)
    nz = vals_pf != 0
    back, wpages = _choose_window(rows_pf, vals_pf, seg_lens, Mp, max_pages)
    wmax = wpages * PAGE

    bands = []
    resid_rows = np.zeros_like(rows_pf)
    resid_vals = np.zeros_like(vals_pf)
    nnz_total = int(nz.sum())
    nnz_fit = 0
    off = 0
    for L in seg_lens:
        C = max(-(-L // Mp), 1)
        # the matvec cores rely on the value-grouped partition's exact
        # ladder (every group padded to the max page load): L == Mp*C
        assert L == Mp * C, (L, Mp, C)
        band = np.zeros((Mp, C, wmax), dtype)
        seg_rows = rows_pf[off : off + L]
        seg_vals = vals_pf[off : off + L]
        seg_nz = nz[off : off + L]
        pos = np.arange(L)
        g = pos // C  # ladder page of each column
        c = pos % C
        lo = ((g - back) * PAGE)[:, None]  # window start row per column
        fits = seg_nz & (seg_rows >= lo) & (seg_rows < lo + wmax)
        col_fits = fits.sum(axis=1) == seg_nz.sum(axis=1)
        nnz_fit += int(seg_nz[col_fits].sum())
        # dense-fill fitting columns (np.add.at: duplicate (row,col) entries
        # in the ELL accumulate, matching the gather path's semantics)
        fi = np.nonzero(col_fits[:, None] & seg_nz)
        if fi[0].size:
            gg = g[fi[0]]
            cc = c[fi[0]]
            ww = seg_rows[fi] - (gg - back) * PAGE
            np.add.at(band, (gg, cc, ww), seg_vals[fi])
        # residual: whole non-fitting columns
        nf = ~col_fits
        resid_rows[off : off + L][nf] = seg_rows[nf]
        resid_vals[off : off + L][nf] = seg_vals[nf]
        bands.append(band)
        off += L
    fit_fraction = nnz_fit / max(nnz_total, 1)
    return bands, back, wpages, fit_fraction, (resid_rows, resid_vals)


def _pad_to(x, n, axis=-1):
    pad = n - x.shape[axis]
    if pad <= 0:
        return x
    cfg = [(0, 0)] * x.ndim
    cfg[axis] = (0, pad)
    return jnp.pad(x, cfg)


# Page contractions.  Under a vmapped scenario axis, plain vmap turns each
# into one batched dot_general over the pages (batch dim g, the scenario
# axis a free dimension), which XLA hands to cuBLAS / its GEMM emitter.


def _zmv(band, seg):  # band (Mp, C, W), seg (Mp, C) -> (Mp, W)
    return jnp.einsum("gcw,gc->gw", band, seg, preferred_element_type=seg.dtype,
                      precision=jax.lax.Precision.HIGHEST)


def _grmv(band, rw):  # band (Mp, C, W), rw (Mp, W) -> (Mp, C)
    return jnp.einsum("gcw,gw->gc", band, rw, preferred_element_type=rw.dtype,
                      precision=jax.lax.Precision.HIGHEST)


def _page_offset(A: DeviceBanded, gl: int):
    """Global ladder-page offset of THIS shard's groups (0 unsharded)."""
    if A.n_shards > 1 and A.col_axis is not None:
        return jax.lax.axis_index(A.col_axis) * gl
    return 0


def _matvec_core(A: DeviceBanded, bands, x_pf, page_off) -> jnp.ndarray:
    """One shard's (or the unsharded) band contribution: full-m partial
    whose nonzero rows lie in pages [page_off - back, page_off + gl -
    back + wpages)."""
    gl = bands[0].shape[0]
    wpages = A.wpages
    Gp = _global_pages(A)
    dt = x_pf.dtype
    Z = None
    off = 0
    for band in bands:
        C = band.shape[1]
        L = gl * C  # exact: the value-grouped partition pads every group
        seg = jax.lax.dynamic_slice_in_dim(x_pf, off, L, axis=-1)
        seg = seg.reshape(gl, C)
        z = _zmv(band, seg)
        Z = z if Z is None else Z + z
        off += L
    # materialisation fence: without it XLA's reducer fusion can inline the
    # whole band contraction into each downstream consumer (on the first
    # build's device the fused pgd step compiled for minutes and ran orders
    # of magnitude slower; not re-measured on the current one)
    Z = jax.lax.optimization_barrier(Z)
    # overlap-add in front-padded page coords (group g starts at padded
    # page g) via wpages STATIC shifted adds (dense update, no scatter)
    pages = jnp.zeros((gl + wpages, PAGE), dt)
    for j in range(wpages):
        pages = pages.at[j : j + gl].add(Z[:, j * PAGE : (j + 1) * PAGE])
    flat = pages.reshape(-1)
    if gl == Gp:  # unsharded / whole ladder: identity placement
        return flat[A.back * PAGE : A.back * PAGE + A.num_rows]
    y = jnp.zeros(((Gp + wpages) * PAGE,), dt)
    y = jax.lax.dynamic_update_slice(y, flat, (page_off * PAGE,))
    return jax.lax.slice(y, (A.back * PAGE,), (A.back * PAGE + A.num_rows,))


def banded_matvec(A: DeviceBanded, x_pf: jnp.ndarray) -> jnp.ndarray:
    """A_band @ x (no gathers/scatters; residual handled by the caller).

    Sharded layouts return this shard's full-m PARTIAL (matvec_ps psums
    over col_axis, same collective as the gather layout)."""
    Gp = _global_pages(A)
    g_here = A.bands[0].shape[0]
    if A.n_shards > 1 and g_here == Gp:
        # global (host/test/eval_shape) view of a sharded layout: x is
        # device-major; evaluate shard by shard and sum the partials
        gl = Gp // A.n_shards
        n_loc = sum((b.shape[0] // A.n_shards) * b.shape[1] for b in A.bands)
        y = None
        for d in range(A.n_shards):
            bands_d = [b[d * gl : (d + 1) * gl] for b in A.bands]
            x_d = jax.lax.dynamic_slice_in_dim(x_pf, d * n_loc, n_loc, axis=-1)
            yd = _matvec_core(A, bands_d, x_d, d * gl)
            y = yd if y is None else y + yd
        return y
    return _matvec_core(A, list(A.bands), x_pf, _page_offset(A, g_here))


def _rmatvec_core(A: DeviceBanded, bands, rp_flat, page_off) -> jnp.ndarray:
    """One shard's A_band^T r segment; ``rp_flat`` is the globally
    front-padded residual of length (pages + wpages) * PAGE."""
    gl = bands[0].shape[0]
    wpages = A.wpages
    rp = jax.lax.dynamic_slice_in_dim(
        rp_flat, page_off * PAGE, (gl + wpages) * PAGE, axis=-1
    ).reshape(gl + wpages, PAGE)
    Rw = jnp.concatenate([rp[j : j + gl] for j in range(wpages)], axis=1)  # (gl, wmax)
    outs = []
    for band in bands:
        C = band.shape[1]
        g = _grmv(band, Rw)
        g = jax.lax.optimization_barrier(g)  # see _matvec_core fence note
        outs.append(g.reshape(gl * C))
    return jnp.concatenate(outs) if len(outs) > 1 else outs[0]


def _rp_flat(A: DeviceBanded, r: jnp.ndarray) -> jnp.ndarray:
    """Front-pad ``back`` zero pages (group g's window then starts at padded
    page g) and tail-pad to the global ladder length."""
    Gp = _global_pages(A)
    rp = jnp.concatenate([jnp.zeros((A.back * PAGE,), r.dtype), r])
    return _pad_to(rp, (Gp + A.wpages) * PAGE)


def banded_rmatvec(A: DeviceBanded, r: jnp.ndarray) -> jnp.ndarray:
    """A_band^T @ r (window reads are page slices — static offsets
    unsharded, one dynamic page-aligned slice per shard when sharded)."""
    Gp = _global_pages(A)
    g_here = A.bands[0].shape[0]
    rp = _rp_flat(A, r)
    if A.n_shards > 1 and g_here == Gp:
        gl = Gp // A.n_shards
        outs = []
        for d in range(A.n_shards):
            bands_d = [b[d * gl : (d + 1) * gl] for b in A.bands]
            outs.append(_rmatvec_core(A, bands_d, rp, d * gl))
        return jnp.concatenate(outs)  # device-major PF order
    return _rmatvec_core(A, list(A.bands), rp, _page_offset(A, g_here))
