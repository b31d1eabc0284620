"""Sharded solve: shard_map'd solver steps over a ('block','scenario') mesh.

Layout (SURVEY.md §2b, §3e):
  * bucket arrays (Bk, w)        -> P('block', None)       x/g/masks by block
  * dense A (m, n_pf)            -> P(None, 'block')       columns by block
  * ELL rows/vals (n_pf, k)      -> P('block', None)       columns by block
  * b (S, m)                     -> P('scenario', None)    RHS by scenario
  * residual r                   -> replicated over 'block' (assembled by psum)

Each device computes its partial A_s @ x_s; the residual assembles with a
single psum over 'block' per iteration; A^T r is then block-local.  Line
search and gap inner products psum likewise (``col_axis='block'`` in the
DeviceProblem makes every L.xdot/L.matvec_ps collective-aware, so the
*same solver step functions* run sharded and unsharded).  Scenarios are
vmapped locally, sharded across the 'scenario' axis.
"""
from __future__ import annotations

import time
from dataclasses import replace
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..models.problem import Problem
from ..ops import layout as L
from .mesh import BLOCK_AXIS, ROW_AXIS, SCENARIO_AXIS

__all__ = ["shard_problem", "solve_sharded"]


# ---------------- spec construction ----------------

# column (block) sharding: A columns + x by block, r replicated
_LEAF_SPECS = {
    "data": P(None, BLOCK_AXIS),  # dense A columns
    "rows": P(BLOCK_AXIS, None),  # ELL (column-oriented)
    "vals": P(BLOCK_AXIS, None),
    "bands": P(BLOCK_AXIS, None, None),  # banded layout: group axis = block
    # ranges in the value-grouped partition (ops/banded.py DeviceBanded)
    "mv_cols": P(BLOCK_AXIS, None, None),  # row-ELL per shard (local indices)
    "mv_vals": P(BLOCK_AXIS, None, None),
    "bottom_scale": P(),
    "mask": P(BLOCK_AXIS, None),
    "sizes": P(BLOCK_AXIS),
    "radius": P(BLOCK_AXIS),
    "b": P(SCENARIO_AXIS, None),
    "perm": P(BLOCK_AXIS),
}

# solver-state kinds (the state-class SHARD_KINDS protocol) -> specs.
# Column(block)-sharded mode: x lives by block, r replicated; row-sharded
# mode: x replicated, r by row shard.  A leading scenario axis always.
_KIND_SPECS = {
    "x": P(SCENARIO_AXIS, BLOCK_AXIS, None),  # padded bucket (S, Bk, w)
    "xflat": P(SCENARIO_AXIS, BLOCK_AXIS),  # PF flat (S, n_pf)
    "xflat_hist": P(SCENARIO_AXIS, None, BLOCK_AXIS),  # (S, M, n_pf) shift buffer
    "hist": P(SCENARIO_AXIS, None),  # (S, M) per-pair scalars
    "gram": P(SCENARIO_AXIS, None, None),  # (S, M, M) replicated Gram
    "r": P(SCENARIO_AXIS, None),  # residual-space (S, m)
    "scalar": P(SCENARIO_AXIS),  # per-scenario scalar
}
_KIND_SPECS_ROWS = {
    "x": P(SCENARIO_AXIS, None, None),
    "xflat": P(SCENARIO_AXIS, None),
    "xflat_hist": P(SCENARIO_AXIS, None, None),
    "hist": P(SCENARIO_AXIS, None),
    "gram": P(SCENARIO_AXIS, None, None),
    "r": P(SCENARIO_AXIS, BLOCK_AXIS),
    "scalar": P(SCENARIO_AXIS),
}

# row sharding (the SP/CP analog for very tall A, SURVEY.md §2b): A rows +
# r by shard, x replicated; A^T r and r-space dots psum over the axis
_LEAF_SPECS_ROWS = {
    "data": P(BLOCK_AXIS, None),  # dense A rows
    "rows": P(BLOCK_AXIS, None, None),  # ELL re-encoded per row shard
    "vals": P(BLOCK_AXIS, None, None),
    "mv_cols": P(BLOCK_AXIS, None, None),
    "mv_vals": P(BLOCK_AXIS, None, None),
    "bottom_scale": P(),
    "mask": P(None, None),
    "sizes": P(None),
    "radius": P(None),
    "b": P(SCENARIO_AXIS, BLOCK_AXIS),
    "perm": P(None),
}

# 2-D (row x col) sharding: the full SURVEY §2b pattern — every device owns
# one (row-shard, col-shard) tile of A; A@x psums over 'block' (cols) to
# assemble this row shard's residual segment, A^T r psums over 'row'.
_LEAF_SPECS_2D = {
    "data": P(ROW_AXIS, BLOCK_AXIS),  # dense A tiles
    "rows": P(ROW_AXIS, BLOCK_AXIS, None, None),  # ELL tile grid
    "vals": P(ROW_AXIS, BLOCK_AXIS, None, None),
    "mv_cols": P(ROW_AXIS, BLOCK_AXIS, None, None),
    "mv_vals": P(ROW_AXIS, BLOCK_AXIS, None, None),
    "bottom_scale": P(),
    "mask": P(BLOCK_AXIS, None),
    "sizes": P(BLOCK_AXIS),
    "radius": P(BLOCK_AXIS),
    "b": P(SCENARIO_AXIS, ROW_AXIS),
    "perm": P(BLOCK_AXIS),
}

_KIND_SPECS_2D = {
    "x": P(SCENARIO_AXIS, BLOCK_AXIS, None),  # x by block, replicated over rows
    "xflat": P(SCENARIO_AXIS, BLOCK_AXIS),
    "xflat_hist": P(SCENARIO_AXIS, None, BLOCK_AXIS),
    "hist": P(SCENARIO_AXIS, None),
    "gram": P(SCENARIO_AXIS, None, None),
    "r": P(SCENARIO_AXIS, ROW_AXIS),  # residual by row shard
    "scalar": P(SCENARIO_AXIS),
}


def _path_name(path) -> str:
    for entry in reversed(path):
        name = getattr(entry, "name", None)
        if name is not None:
            return str(name)
        # tuple/list index inside xp: keep walking up to the field name
    return ""


def dp_specs(dp: L.DeviceProblem, rows: bool = False, grid: bool = False):
    """PartitionSpec pytree matching a DeviceProblem."""
    table = _LEAF_SPECS_2D if grid else (_LEAF_SPECS_ROWS if rows else _LEAF_SPECS)

    def spec_for(path, leaf):
        name = _path_name(path)
        if name in table:
            return table[name]
        raise ValueError(f"no sharding rule for DeviceProblem leaf {path}")

    return jax.tree_util.tree_map_with_path(spec_for, dp)


def state_specs(state, rows: bool = False, grid: bool = False):
    """PartitionSpec pytree for a solver state (leading scenario axis).

    Specs derive from the state class's ``SHARD_KINDS`` protocol — a dict
    mapping each field to one of "x" (padded buckets, block-sharded),
    "xflat" (PF flat), "r" (residual-space) or "scalar" — so new solvers
    declare their own sharding next to their state instead of editing this
    module.  ``state`` may be the concrete state or an eval_shape struct
    with the same type.
    """
    kinds = getattr(type(state), "SHARD_KINDS", None)
    if kinds is None:
        raise TypeError(
            f"{type(state).__name__} has no SHARD_KINDS: solver states must "
            "declare a field->kind dict (kinds: x, xflat, r, scalar) to run "
            "under a mesh"
        )
    table = _KIND_SPECS_2D if grid else (_KIND_SPECS_ROWS if rows else _KIND_SPECS)
    specs = {}
    for fname, val in state._asdict().items():
        if fname not in kinds:
            raise ValueError(
                f"{type(state).__name__}.SHARD_KINDS is missing field {fname!r}"
            )
        kind = kinds[fname]
        if kind not in table:
            raise ValueError(f"unknown shard kind {kind!r} for field {fname!r}")
        spec = table[kind]
        specs[fname] = jax.tree_util.tree_map(lambda _: spec, val)
    return type(state)(**specs)


# ---------------- problem sharding ----------------


def shard_problem(problem: Problem, mesh, dtype=jnp.float32,
                  equilibrate: bool = True, layout: str = "auto"):
    """Prepare + device_put a Problem onto the mesh.

    Rebuilds the partition so every bucket's rows divide the block axis and
    lays A's columns out device-major (L.prepare(n_shards=nb)).
    Returns (dp_sharded, part) where dp.col_axis='block'.  When the banded
    layout is selected (corridor-structured A, small S, or
    layout='banded'), ``part`` is the value-grouped partition the band
    ladder solves under — extraction maps through it.
    """
    from ..models.partition import BlockPartition

    nb = mesh.shape[BLOCK_AXIS]
    ns = mesh.shape[SCENARIO_AXIS]
    part = problem.partition
    if any(b.num_blocks % nb for b in part.buckets):
        part = BlockPartition.from_sizes(part.sizes, block_multiple=nb)
        problem = replace(problem, partition=part)
    b = np.asarray(problem.b)
    if b.ndim == 1:
        b = b[None, :]
    if b.shape[0] % ns:
        raise ValueError(f"num scenarios {b.shape[0]} not divisible by scenario axis {ns}")
    problem = replace(problem, b=b)
    out_info: dict = {}
    dp = L.prepare(problem, dtype=dtype, n_shards=nb, col_axis=BLOCK_AXIS,
                   equilibrate=equilibrate, layout=layout, _out=out_info)
    part = out_info.get("partition", part)
    specs = dp_specs(dp)
    dp = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), dp, specs
    )
    return dp, part


def interleave_stacked_rows(b_top: np.ndarray, b_bot: np.ndarray,
                            nr: int) -> np.ndarray:
    """Arrange a stacked RHS [b_top; b_bot] ((S, m) and (S, p)) into the
    row-sharded VStack device layout, where shard k owns the locally
    stacked rows [top_k; bottom_k]: pad each part to a multiple of nr,
    split it into nr row segments, and concatenate segment-wise."""
    S = b_top.shape[0]
    bt = np.concatenate(
        [b_top, np.zeros((S, (-b_top.shape[1]) % nr), b_top.dtype)], axis=1)
    bb = np.concatenate(
        [b_bot, np.zeros((S, (-b_bot.shape[1]) % nr), b_bot.dtype)], axis=1)
    bt = bt.reshape(S, nr, -1)
    bb = bb.reshape(S, nr, -1)
    return np.concatenate([bt, bb], axis=2).reshape(S, -1)


def shard_problem_rows(problem: Problem, mesh, dtype=jnp.float32):
    """Row-sharded preparation (tall-A / SP-analog): A's ROWS and r are
    sharded over the block axis, x is replicated.  Dense A shards by row
    slicing; ELL A is re-encoded per shard in both orientations
    (L._build_ell_row_sharded) with local row ids, so each device gathers
    only from its own r segment and A^T r partials psum.  Rows are
    zero-padded so the axis divides m (zero rows contribute nothing to a
    least-squares residual).

    A stacked ``VStackMatrix`` (the eq path's [A; sqrt(rho) C]) row-shards
    BOTH parts: device k owns the locally stacked [A_k; sr*C_k], and b is
    interleaved to match (``interleave_stacked_rows``); the resulting dp is
    meant for shard_map execution (matvec/rmatvec resolve the local
    top/bottom boundary from the array shapes)."""
    from ..models.problem import (
        DenseMatrix, EllMatrix, ScaledMatrix, VStackMatrix,
    )

    nr = mesh.shape[BLOCK_AXIS]
    ns = mesh.shape[SCENARIO_AXIS]
    b = np.asarray(problem.b)
    if b.ndim == 1:
        b = b[None, :]
    if b.shape[0] % ns:
        raise ValueError(f"num scenarios {b.shape[0]} not divisible by scenario axis {ns}")
    m = problem.A.shape[0]
    pad = (-m) % nr
    row_shards = 1
    if isinstance(problem.A, VStackMatrix):
        # stacked eq operator: row-shard BOTH parts, interleave b so each
        # device's b segment is its locally stacked [b_top_k; b_bot_k]
        vs = problem.A
        top, bot, scale = vs.top, vs.bottom, None
        if isinstance(bot, ScaledMatrix):
            scale, bot = bot.scale, bot.inner
        mt = top.shape[0]

        def _pad_rows(M, padr):
            if padr == 0:
                return M
            if isinstance(M, DenseMatrix):
                return DenseMatrix(np.concatenate(
                    [M.data, np.zeros((padr, M.shape[1]), M.data.dtype)],
                    axis=0))
            return EllMatrix(rows=M.rows, vals=M.vals,
                             num_rows=M.shape[0] + padr)

        top_p = _pad_rows(top, (-mt) % nr)
        bot_p = _pad_rows(bot, (-bot.shape[0]) % nr)
        A = VStackMatrix(
            top=top_p,
            bottom=ScaledMatrix(bot_p, scale) if scale is not None else bot_p,
        )
        b = interleave_stacked_rows(b[:, :mt], b[:, mt:], nr)
        problem = replace(problem, A=A, b=b)
        dp = L.prepare(problem, dtype=dtype, n_shards=1,
                       row_axis=BLOCK_AXIS, row_shards=nr)
        specs = dp_specs(dp, rows=True)
        dp = jax.tree_util.tree_map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), dp, specs
        )
        return dp, problem.partition
    if isinstance(problem.A, DenseMatrix):
        A = problem.A.data
        if pad:
            A = np.concatenate([A, np.zeros((pad, A.shape[1]), A.dtype)], axis=0)
        A = DenseMatrix(A)
    elif isinstance(problem.A, EllMatrix):
        A = problem.A
        if pad:
            A = EllMatrix(rows=A.rows, vals=A.vals, num_rows=m + pad)
        row_shards = nr
    else:
        raise NotImplementedError(
            f"row sharding supports dense and ELL A, got {type(problem.A)}. "
            "For bandable (corridor) instances use block sharding with "
            "layout='banded' — it IS row sharding there: band groups own "
            "advancing row windows, so an 8-way group shard already touches "
            "little more than 1/8 of the row pages (plus a wpages halo); a "
            "separate "
            "row axis would re-shard the same diagonal and cannot shrink "
            "per-shard band bytes further."
        )
    if pad:
        b = np.concatenate([b, np.zeros((b.shape[0], pad), b.dtype)], axis=1)
    problem = replace(problem, A=A, b=b)
    dp = L.prepare(
        problem, dtype=dtype, n_shards=1, row_axis=BLOCK_AXIS, row_shards=row_shards
    )
    specs = dp_specs(dp, rows=True)
    dp = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), dp, specs
    )
    return dp, problem.partition


def shard_problem_2d(problem: Problem, mesh, dtype=jnp.float32):
    """2-D (row x col) sharded preparation: every device owns one tile of A
    (ELL re-encoded per tile with local row AND local column ids; dense A
    sliced by NamedSharding).  Rows pad to the row axis; the partition pads
    to the block axis."""
    from ..models.partition import BlockPartition
    from ..models.problem import DenseMatrix, EllMatrix

    nr = mesh.shape[ROW_AXIS]
    nc = mesh.shape[BLOCK_AXIS]
    ns = mesh.shape[SCENARIO_AXIS]
    part = problem.partition
    if any(bk.num_blocks % nc for bk in part.buckets):
        part = BlockPartition.from_sizes(part.sizes, block_multiple=nc)
        problem = replace(problem, partition=part)
    b = np.asarray(problem.b)
    if b.ndim == 1:
        b = b[None, :]
    if b.shape[0] % ns:
        raise ValueError(f"num scenarios {b.shape[0]} not divisible by scenario axis {ns}")
    m = problem.A.shape[0]
    pad = (-m) % nr
    A = problem.A
    if isinstance(A, DenseMatrix):
        if pad:
            A = DenseMatrix(np.concatenate(
                [A.data, np.zeros((pad, A.data.shape[1]), A.data.dtype)], axis=0))
    elif isinstance(A, EllMatrix):
        if pad:
            A = EllMatrix(rows=A.rows, vals=A.vals, num_rows=m + pad)
    else:
        raise NotImplementedError(
            f"2-D sharding supports dense/ELL A, got {type(A)}. For "
            "bandable instances block-sharded layout='banded' already "
            "row-shards (group windows advance with the rows, plus a small "
            "halo), so a row axis adds nothing."
        )
    if pad:
        b = np.concatenate([b, np.zeros((b.shape[0], pad), b.dtype)], axis=1)
    problem = replace(problem, A=A, b=b)
    dp = L.prepare(
        problem, dtype=dtype, n_shards=nc, col_axis=BLOCK_AXIS,
        row_axis=ROW_AXIS, row_shards=nr,
    )
    specs = dp_specs(dp, grid=True)
    dp = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), dp, specs
    )
    return dp, part


# ---------------- sharded driver ----------------


def inject_sharded(dp, part, x_user: np.ndarray, mesh):
    """Inverse of extract_sharded: (S, N) user-flat -> sharded padded bucket
    arrays (equilibration-scaled), placed with the state's xp sharding."""
    x_user = np.asarray(x_user, np.float32)
    if x_user.ndim == 1:
        x_user = x_user[None, :]
    S = x_user.shape[0]
    out = []
    for b, bk in zip(part.buckets, dp.buckets):
        radius = _radius_host(bk)
        arr = np.zeros((S, bk.mask.shape[0], b.width), np.float32)
        m = b.mask.astype(bool)
        vals = x_user[:, b.pad_to_flat] * radius[None, :, None]
        arr[:, m] = vals[:, m]
        if dp.row_axis and dp.col_axis:
            spec = _KIND_SPECS_2D["x"]
        elif dp.row_axis:
            spec = _KIND_SPECS_ROWS["x"]
        else:
            spec = _KIND_SPECS["x"]
        out.append(jax.device_put(jnp.asarray(arr), NamedSharding(mesh, spec)))
    return tuple(out)


def to_host(x):
    """Fetch a (possibly globally-sharded) array pytree to full numpy arrays.

    Decided per leaf on ADDRESSABILITY, not process count: only leaves with
    shards on other hosts need multihost_utils.process_allgather (which
    replicates them — every process gets the full value); fully-addressable
    leaves go through plain np.asarray.  Feeding an already-addressable
    array to process_allgather would CONCATENATE it across processes
    (host-local-data semantics) and return an nproc-times-larger array.
    """
    def fetch(leaf):
        if isinstance(leaf, jax.Array) and not leaf.is_fully_addressable:
            from jax.experimental import multihost_utils

            return np.asarray(multihost_utils.process_allgather(leaf, tiled=True))
        return np.asarray(leaf)

    return jax.tree_util.tree_map(fetch, x)


# host copies of per-bucket radii (static for the lifetime of a prepared
# problem): the AL outer loop and the serving path call inject/extract once
# per outer/request, and each cross-host gather is a collective dispatch —
# memoise keyed on the device array's identity (the cached entry holds the
# array itself, so the id cannot be recycled while the entry lives).
_RADIUS_HOST_CACHE: dict = {}


def _radius_host(bk) -> np.ndarray:
    key = id(bk.radius)
    hit = _RADIUS_HOST_CACHE.get(key)
    if hit is not None and hit[0] is bk.radius:
        return hit[1]
    r = to_host(bk.radius)
    if len(_RADIUS_HOST_CACHE) >= 64:
        _RADIUS_HOST_CACHE.clear()
    _RADIUS_HOST_CACHE[key] = (bk.radius, r)
    return r


def extract_sharded(dp, part, xp) -> np.ndarray:
    """Host-side extraction for the sharded path: (S, N) user-flat solution.

    Uses the partition's own bucket->flat maps (bucket row order is
    unchanged by sharding), NOT dp.perm — the PF perm is device-major while
    a bucket-wise concat is bucket-major, so perm-based extraction would
    scramble multi-bucket (ragged) problems.
    """
    xs = [to_host(x) for x in xp]  # each (S, Bk, w)
    S = xs[0].shape[0]
    out = np.zeros((S, part.n_flat), xs[0].dtype)
    for b, bk, x in zip(part.buckets, dp.buckets, xs):
        radius = _radius_host(bk)  # (Bk,)
        m = b.mask.astype(bool)
        vals = x / np.maximum(radius, 1e-30)[None, :, None]
        out[:, b.pad_to_flat[m]] = vals[:, m]
    return out


def solve_sharded(
    problem: Problem,
    mesh,
    method: str = "pgd",
    tol: float = 1e-6,
    max_iter: int = 10_000,
    chunk: int = 100,
    line_search: str = "exact",
    step_size: float = 0.0,
    unroll: int = 1,
    dtype=jnp.float32,
    verbose: bool = False,
    metrics=None,
    checkpoint_path=None,
    checkpoint_every: int = 0,
    checkpoint_keep: int = 0,
    resume: bool = False,
    shard_rows: bool = False,
    x0=None,
    stop_rule: str = "auto",
    lbfgs_mem: int = 8,
    lipschitz=None,
    layout: str = "auto",
    refine: int = 0,
    refine_tol=None,
):
    """Mesh-sharded solve.  Same semantics as bsls_tpu.solve; b is treated as
    (S, m) (S=1 for a single RHS) and results keep the scenario axis.

    ``problem`` may be a pre-sharded ``(dp, part, single_rhs)`` triple from
    ``shard_problem`` (the serving path prepares/uploads once and streams
    right-hand sides); ``lipschitz`` skips the on-mesh power iteration.

    ``shard_rows=True`` shards A's ROWS over the block axis instead of its
    columns (the tall-A / sequence-parallel analog, dense A only): the
    residual is row-local, A^T r and r-space inner products psum."""
    from ..solvers.base import (
        SolveOptions, SolveResult, StopTracker, _get_solver, power_lipschitz,
        power_lipschitz_z, uses_zspace,
    )

    if isinstance(problem, Problem) and problem.C is not None:
        from ..solvers.eq_constrained import solve_equality_constrained

        return solve_equality_constrained(
            problem, method=method, tol=tol, max_iter=max_iter, chunk=chunk,
            line_search=line_search, step_size=step_size, dtype=dtype, mesh=mesh,
            unroll=unroll, lbfgs_mem=lbfgs_mem, x0=x0, metrics=metrics,
            checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
            checkpoint_keep=checkpoint_keep, resume=resume,
            shard_rows=shard_rows, refine=refine, refine_tol=refine_tol,
        )
    if refine > 0 or refine_tol is not None:
        if not isinstance(problem, Problem):
            raise ValueError(
                "refine on a sharded solve needs the host Problem (the "
                "polish anchor is a host float64 pass); pass the Problem, "
                "not a pre-sharded triple")

    grid = dict(mesh.shape).get(ROW_AXIS, 1) > 1
    if grid and shard_rows:
        raise ValueError("use either a row>1 mesh axis (2-D) or shard_rows, not both")
    if isinstance(problem, tuple):
        # pre-sharded (dp, part, single_rhs) from shard_problem /
        # shard_problem_rows — the serving and eq paths prepare/upload once
        # and stream right-hand sides.  The dp carries its own axis
        # metadata, so the mode is derived from it, not from the flag.
        dp, part, single_rhs = problem
        if grid:
            raise ValueError("pre-sharded solves do not support a 2-D grid")
        shard_rows = dp.row_axis is not None and dp.col_axis is None
    else:
        single_rhs = np.asarray(problem.b).ndim == 1
        if grid:
            dp, part = shard_problem_2d(problem, mesh, dtype=dtype)
        elif shard_rows:
            dp, part = shard_problem_rows(problem, mesh, dtype=dtype)
        else:
            dp, part = shard_problem(problem, mesh, dtype=dtype, layout=layout)
    opts = SolveOptions(
        method=method, line_search=line_search, tol=tol,
        max_iter=max_iter, chunk=chunk, step_size=step_size, unroll=unroll,
        lbfgs_mem=lbfgs_mem,
    )
    solver = _get_solver(method)
    dspecs = dp_specs(dp, rows=shard_rows, grid=grid)

    if lipschitz is not None:
        L_est = jnp.asarray(lipschitz, dp.b.dtype)
    else:
        # line_search="pava" builds the trial point in z-space and needs the
        # z-curvature ||A D||^2 (solve_sharded is space="x"-only otherwise)
        power = (
            power_lipschitz_z if uses_zspace(method, line_search)
            else power_lipschitz
        )
        lips = jax.jit(
            jax.shard_map(power, mesh=mesh, in_specs=(dspecs,), out_specs=P())
        )
        L_est = lips(dp)

    def _init(dp_loc, L_loc):
        return jax.vmap(lambda b: solver.init(replace(dp_loc, b=b), L_loc, opts))(dp_loc.b)

    # out_specs for shard_map are declared by state-field name; derive the
    # state *structure* (not shapes) via eval_shape with collectives disabled
    state_struct = jax.eval_shape(
        lambda d: jax.vmap(
            lambda b: solver.init(
                replace(d, b=b, col_axis=None, row_axis=None), jnp.asarray(1.0, dtype), opts
            )
        )(d.b),
        dp,
    )
    sspecs = state_specs(state_struct, rows=shard_rows, grid=grid)

    init_fn = jax.jit(
        jax.shard_map(_init, mesh=mesh, in_specs=(dspecs, P()), out_specs=sspecs)
    )
    state = init_fn(dp, L_est)
    if x0 is not None:
        # warm start: overwrite the iterate(s); stale residual/momentum
        # fields are rebuilt by solver.refresh at the next chunk boundary
        xp0 = inject_sharded(dp, part, x0, mesh)
        state = state._replace(xp=xp0)
        if hasattr(state, "yp"):
            state = state._replace(yp=xp0)

    def _chunk(dp_loc, L_loc, st):
        def per_scen(b, s):
            d = replace(dp_loc, b=b)
            s = solver.refresh(d, s, L_loc, opts)

            def body(s2, _):
                s3 = solver.step(d, s2, L_loc, opts)
                return s3, (s3.f, s3.gap)

            return jax.lax.scan(body, s, None, length=chunk, unroll=unroll)

        st2, trace = jax.vmap(per_scen)(dp_loc.b, st)
        return st2, trace

    trace_spec = (P(SCENARIO_AXIS, None), P(SCENARIO_AXIS, None))
    chunk_fn = jax.jit(
        jax.shard_map(
            _chunk, mesh=mesh, in_specs=(dspecs, P(), sspecs),
            out_specs=(sspecs, trace_spec),
        )
    )
    # AOT-compile so chunk_times[0] measures execution, not XLA compile;
    # cache the executable by (mesh, opts, layout, abstract signature) —
    # .lower().compile() bypasses jit's cache, and the eq-constrained AL
    # outer loop calls solve_sharded once per outer on identical shapes
    from ..solvers.base import cached_executable

    _fn = chunk_fn
    chunk_fn = cached_executable(
        (mesh, opts, shard_rows, grid), (dp, L_est, state),
        lambda: _fn.lower(dp, L_est, state).compile(),
    )

    it = 0
    if resume and checkpoint_path:
        from ..utils.checkpoint import latest_checkpoint, load_state

        ck = latest_checkpoint(checkpoint_path)
        if ck:
            state, meta = load_state(ck, state)
            it = int(meta.get("iteration", 0))
            # restore the mesh shardings the compiled chunk expects
            state = jax.tree_util.tree_map(
                lambda x, s: jax.device_put(jnp.asarray(x), NamedSharding(mesh, s)),
                state, sspecs,
            )

    # async chunk loop with adaptive sync cadence — same design as
    # solvers/base.py solve(): chunks enqueue without blocking, traces stay
    # on device until the end, and convergence stats come back in one packed
    # transfer every `sync_every` chunks (host readbacks stall the device
    # and can dominate small per-chunk walls).
    from ..solvers.base import MAX_SYNC_CHUNKS, SYNC_TARGET_SECS

    from ..solvers.base import MAX_SYNC_CHUNKS_TOL

    traces_f, traces_g, ctimes, citers = [], [], [], []
    converged = False
    stopper = StopTracker(tol, stop_rule)
    chunks_done = 0
    sync_every, since_sync = 1, 0
    max_sync = MAX_SYNC_CHUNKS if tol <= 0 else MAX_SYNC_CHUNKS_TOL
    eager_host = bool(verbose or (checkpoint_path and checkpoint_every))
    t0 = time.perf_counter()
    while it < max_iter:
        state, (tf, tg) = chunk_fn(dp, L_est, state)
        it += chunk
        chunks_done += 1
        since_sync += 1
        traces_f.append(tf)  # (S, chunk), device
        traces_g.append(tg)
        if since_sync < sync_every and it < max_iter and not eager_host:
            continue
        citers.append(it)
        # packed end-of-chunk stats for the whole interval (one fixed-shape
        # transfer); the stopper replays them per chunk — same semantics as
        # the synchronous loop, decision at most sync_every chunks late
        from ..solvers.base import MAX_SYNC_CHUNKS as _MS, pack_chunk_stats

        k_sync = min(since_sync, _MS)
        fg = to_host(pack_chunk_stats(traces_f, traces_g, k_sync,
                                      state.f.dtype))  # (2, 32, S)
        t1 = time.perf_counter()
        ctimes.append(t1 - t0)
        t0 = t1
        stop_at = None
        for j in range(k_sync):
            rel_j = fg[1, j] / np.maximum(1.0, np.abs(fg[0, j]))
            if stopper.update(fg[0, j], rel_j):
                stop_at = j
                break
        f_last, gap_last = fg[0, -1], fg[1, -1]
        rel = gap_last / np.maximum(1.0, np.abs(f_last))
        # metrics/prints on process 0 only (every process sees the same
        # gathered stats on a pod; checkpoints stay per-process — each
        # writes its own shard file)
        if metrics is not None and jax.process_index() == 0:
            metrics.log("chunk", iteration=it, f=f_last.tolist(),
                        relgap=rel.tolist(), secs=ctimes[-1])
        if checkpoint_path and checkpoint_every and chunks_done % checkpoint_every == 0:
            from ..utils.checkpoint import save_state

            save_state(checkpoint_path, state, meta={"iteration": it}, keep=checkpoint_keep)
        if verbose and jax.process_index() == 0:
            print(f"[sharded] iter {it}: f={f_last} relgap={rel}")
        if stop_at is not None:
            converged = True
            it -= (k_sync - 1 - stop_at) * chunk
            break
        chunk_wall = ctimes[-1] / since_sync
        sync_every = int(np.clip(round(SYNC_TARGET_SECS / max(chunk_wall, 1e-6)),
                                 1, max_sync))
        if jax.process_count() > 1:
            # cadence must be identical on every process — it decides WHEN
            # the next cross-process gather happens, and per-process wall
            # clocks differ; diverged cadences would issue mismatched
            # collectives (chunk_fn on one host, the stats gather on
            # another) and deadlock the pod.  Broadcast proc 0's choice.
            from jax.experimental import multihost_utils

            sync_every = int(multihost_utils.broadcast_one_to_all(
                np.asarray(sync_every, np.int32)))
        since_sync = 0
    if checkpoint_path and checkpoint_every:
        from ..utils.checkpoint import save_state

        save_state(checkpoint_path, state, meta={"iteration": it}, keep=checkpoint_keep)

    # host-side extraction (global arrays gather transparently)
    from ..ops.projection import proj_blocks

    xp = jax.vmap(lambda p: proj_blocks(p, dp.buckets))(state.xp)
    x = extract_sharded(dp, part, xp)
    if not traces_f:  # resumed past max_iter: nothing ran this call
        empty = np.zeros((np.asarray(dp.b).shape[0], 0), np.float32)
        trace_f, trace_gap = empty, empty
    else:
        # traces lived on device during the loop: one transfer each
        trace_f = to_host(jnp.concatenate(traces_f, axis=1))
        trace_gap = to_host(jnp.concatenate(traces_g, axis=1))
    f = to_host(state.f)
    gap = to_host(state.gap)
    if single_rhs:
        x, f, gap = x[0], f[0], gap[0]
    res = SolveResult(
        x=x,
        objective=f,
        gap=gap,
        iterations=it,
        converged=converged,
        trace_f=trace_f,
        trace_gap=trace_gap,
        chunk_times=np.asarray(ctimes),
        chunk_iters=np.asarray(citers),
        stop_reason=stopper.reason,
    )
    if refine > 0 or refine_tol is not None:
        # gather-and-polish (same as bsls.solve's mesh branch): the result
        # is already host-side; the host f64 CG path (dp=None) runs the
        # tangent-space correction against the host Problem
        from ..solvers.base import refine_polish

        res = refine_polish(problem, None, res,
                            rounds=refine if refine > 0 else 16,
                            target_rel_gap=refine_tol)
    return res
