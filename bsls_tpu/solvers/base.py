"""Solver protocol and the host-side solve driver.

Every solver module exposes pure, jit/scan-compatible functions

    init(dp, opts)  -> state        (state is a NamedTuple pytree)
    step(dp, state, opts) -> state  (one iteration)
    refresh(dp, state, opts) -> state  (recompute exact residual/objective)

State always carries: xp (padded iterate), r (residual), f (objective),
gap (Frank-Wolfe duality gap — a true optimality certificate on products of
simplices: f(x) - f* <= gap), k (iteration counter).

The driver compiles a K-iteration ``lax.scan`` chunk once and loops it from
the host, reading back the (f, gap) trace each chunk — convergence checks,
wall-clock trace, checkpointing and metrics all amortise over the chunk
(SURVEY.md §3e).  Solvers never branch on data on the host inside a chunk.

Iterations use an *incremental residual* (r += t * A d), so PGD/FW cost two
matvec-equivalents per iteration; ``refresh`` recomputes r exactly at every
chunk boundary to stop fp drift.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, replace
from functools import partial
from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models.problem import Problem
from ..ops import layout as L
from ..ops.simplex import block_min

__all__ = [
    "SolveOptions", "SolveResult", "fw_gap", "power_lipschitz",
    "power_lipschitz_z", "uses_zspace", "solve",
]

# async chunk-loop sync cadence (see the loop in solve()): aim for this many
# seconds of enqueued device compute between host readbacks, capped to bound
# the stop-decision lag.  Tuned for the first build's slow readbacks; due
# for re-derivation from the current device's idle share.
SYNC_TARGET_SECS = 0.5
MAX_SYNC_CHUNKS = 32  # tol<=0 (fixed-budget) runs
MAX_SYNC_CHUNKS_TOL = 8  # tol>0: bound the stop-decision lag


def pack_chunk_stats(traces_f, traces_g, k, dtype):
    """End-of-chunk (f, gap) for the last ``k`` chunks as ONE fixed-shape
    (2, MAX_SYNC_CHUNKS, S|1) device array.  Fixed shape matters: the pack
    program compiles once per solve instead of once per distinct interval
    width (each compile costs seconds), so the tail is padded by repeating
    the last chunk's stats — the host replays only the first ``k``
    entries."""
    fs = [jnp.atleast_1d(t[..., -1]) for t in traces_f[-k:]]
    gs = [jnp.atleast_1d(t[..., -1]).astype(dtype) for t in traces_g[-k:]]
    pad = MAX_SYNC_CHUNKS - len(fs)
    fs = fs + [fs[-1]] * pad
    gs = gs + [gs[-1]] * pad
    return jnp.stack([jnp.stack(fs), jnp.stack(gs)])


@dataclass(frozen=True)
class SolveOptions:
    """Static solver options (hashable: becomes part of the jit cache key)."""

    method: str = "pgd"  # pgd | apgd | lbfgs | eg | frank_wolfe | afw
    line_search: str = "exact"  # exact | bb | bbm | fixed | pava
    tol: float = 1e-6  # relative FW-gap tolerance: gap <= tol * max(1, |f|)
    max_iter: int = 10_000
    chunk: int = 100  # iterations per compiled scan chunk
    step_size: float = 0.0  # fixed step (0 -> 1/L from power iteration)
    space: str = "x"  # x | z  (z-space PGD/L-BFGS project with PAVA)
    unroll: int = 1  # lax.scan unroll: amortises per-iteration op overhead
    lbfgs_mem: int = 8  # curvature-pair memory depth (method="lbfgs")


class CommonState(NamedTuple):
    xp: tuple
    r: jnp.ndarray
    f: jnp.ndarray
    gap: jnp.ndarray
    k: jnp.ndarray


@dataclass
class SolveResult:
    x: np.ndarray  # flat solution (N,) or (S, N)
    objective: float | np.ndarray
    gap: float | np.ndarray
    iterations: int
    converged: bool
    trace_f: np.ndarray  # (iters,) or (S, iters)
    trace_gap: np.ndarray
    chunk_times: np.ndarray  # wall seconds per chunk
    chunk_iters: np.ndarray  # cumulative iteration count per chunk boundary
    eq_violation: Optional[float] = None  # ||Cx-d||_inf (equality-constrained)
    stop_reason: str = "max_iter"  # "gap" | "stall" | "gap/stall" | "max_iter"
    refine_secs: float = 0.0  # wall seconds spent in refine_polish (refine=K)
    # float64 FW duality-gap certificate of the polished iterate, relative
    # (gap / max(1, |f|), worst scenario): f - f* <= refine_fw_gap is SOUND
    # with no oracle.  Set by refine_polish when target_rel_gap is given.
    refine_fw_gap: Optional[float] = None

    def steady_iters_per_sec(self, skip: int = 1) -> float:
        """Solver iterations/sec from the paired (chunk_iters, chunk_times)
        sync records, skipping the first ``skip`` intervals (compile and
        warm-up land there).  Entries may span several chunks under
        the async loop, so the rate is iterations-spanned / seconds-spanned
        — NOT chunk/median(times)."""
        t = np.asarray(self.chunk_times, float)
        i = np.asarray(self.chunk_iters, float)
        if t.size == 0 or i.size == 0:
            return 0.0
        if t.size <= skip:
            skip = 0
        start = i[skip - 1] if skip else 0.0
        dt = float(np.sum(t[skip:]))
        return float((i[-1] - start) / dt) if dt > 0 else 0.0

    def time_to_gap(self, f_star: float, rel: float = 1e-6) -> float | None:
        """Wall seconds until f <= f* + rel*max(1,|f*|), from the chunk trace."""
        thresh = f_star + rel * max(1.0, abs(f_star))
        tf = self.trace_f if self.trace_f.ndim == 1 else self.trace_f.max(axis=0)
        hits = np.nonzero(tf <= thresh)[0]
        if hits.size == 0:
            return None
        it = hits[0] + 1
        # linear interpolation of wall time within the chunk trace
        cum_t = np.concatenate([[0.0], np.cumsum(self.chunk_times)])
        cum_i = np.concatenate([[0], self.chunk_iters])
        return float(np.interp(it, cum_i, cum_t))


class StopTracker:
    """Per-chunk convergence decision shared by the solve drivers.

    A scenario counts as converged when either
      * its relative FW gap is <= tol  (sound optimality certificate), or
      * (stop_rule "stall"/"auto") its RUNNING-BEST objective improved by
        less than ``stall_frac * tol * max(1, |f|)`` over each of
        ``patience`` consecutive chunks — the practical criterion: the
        FW-gap certificate is loose on ill-conditioned instances (it
        stalls orders of magnitude above the objective's true gap), so
        gap-only stopping would always exhaust max_iter there.  Tracking
        the best (not last) objective keeps non-monotone methods (bb) from
        registering oscillation as progress — though a chunk-scale plateau
        mid-oscillation can still stop early; use stop_rule="gap" for
        certificate-only stopping.
    """

    def __init__(self, tol: float, stop_rule: str = "auto", patience: int = 2,
                 stall_frac: float = 0.1):
        if stop_rule not in ("gap", "stall", "auto"):
            raise ValueError(f"unknown stop_rule {stop_rule!r}")
        self.tol = tol
        # tol<=0 means "run the full budget": stall detection would trigger
        # spuriously at the fp floor, so fall back to the (unreachable) gap rule
        self.rule = stop_rule if tol > 0 else "gap"
        self.patience = patience
        self.thresh = stall_frac * tol
        self._f_best = None
        self._stall = None
        self.reason = "max_iter"

    def update(self, f_last: np.ndarray, rel_gap: np.ndarray) -> bool:
        f_last = np.atleast_1d(np.asarray(f_last, np.float64))
        rel_gap = np.atleast_1d(np.asarray(rel_gap, np.float64))
        gap_ok = rel_gap <= self.tol
        if self._stall is None:
            self._stall = np.zeros(f_last.shape, np.int64)
        if self._f_best is not None:
            new_best = np.minimum(self._f_best, f_last)
            df = (self._f_best - new_best) / np.maximum(1.0, np.abs(new_best))
            self._stall = np.where(df <= self.thresh, self._stall + 1, 0)
            self._f_best = new_best
        else:
            self._f_best = f_last
        stalled = self._stall >= self.patience
        if self.rule == "gap":
            done = gap_ok
        elif self.rule == "stall":
            done = stalled
        else:
            done = gap_ok | stalled
        if bool(np.all(done)):
            by_gap, by_stall = bool(np.all(gap_ok)), bool(np.all(stalled))
            self.reason = "gap" if by_gap else ("stall" if by_stall else "gap/stall")
            return True
        return False


def fw_gap(dp, g_flat: jnp.ndarray, x_flat: jnp.ndarray, gp) -> jnp.ndarray:
    """Frank-Wolfe duality gap g.(x - s) on the product of (radius-scaled)
    simplices; psums over the block axis when sharded."""
    total_min = jnp.asarray(0.0, g_flat.dtype)
    for g, bk in zip(gp, dp.buckets):
        bm = block_min(g, bk.mask)
        valid = jnp.any(bk.mask > 0, axis=-1)
        total_min = total_min + jnp.sum(jnp.where(valid, bk.radius * bm, 0.0))
    gx = jnp.vdot(g_flat, x_flat).real
    return L.psum_if_sharded(dp, gx - total_min)


def power_lipschitz(dp: L.DeviceProblem, iters: int = 30, seed: int = 0) -> jnp.ndarray:
    """||A||_2^2 estimate by power iteration on A^T A (device-side, jittable,
    collective-aware under a sharded mesh)."""
    key = jax.random.PRNGKey(seed)
    if dp.col_axis:
        # per-shard slice of the global random vector (also marks the value
        # as varying over the block axis for shard_map's VMA tracking)
        key = jax.random.fold_in(key, jax.lax.axis_index(dp.col_axis))
    v = jax.random.normal(key, (dp.n_pf,), dtype=dp.b.dtype)
    v = v / jnp.sqrt(jnp.maximum(L.xdot(dp, v, v), 1e-30))

    def body(_, carry):
        v, lam = carry
        w = L.rmatvec_ps(dp, L.matvec_ps(dp, v))
        lam = jnp.sqrt(jnp.maximum(L.xdot(dp, w, w), 1e-30))
        return w / lam, lam

    _, lam = jax.lax.fori_loop(0, iters, body, (v, jnp.asarray(1.0, dp.b.dtype)))
    return lam * 1.05


def uses_zspace(method: str, line_search: str, space: str = "x") -> bool:
    """True when the solver builds its trial point in z-space (order simplex),
    so the 1/L trial step must use the z-space curvature ||A D||^2, not
    ||A||^2 — the cumulative-sum map D inflates curvature by O(w^2) and an
    x-space L stalls convergence by orders."""
    return space == "z" or (line_search == "pava" and method in ("pgd",))


def power_lipschitz_z(dp: L.DeviceProblem, iters: int = 30, seed: int = 0) -> jnp.ndarray:
    """||A D||_2^2 estimate by power iteration on D^T A^T A D — the curvature
    of the z-parametrisation (D = per-block cumulative-sum map, ztransform).
    Device-side, jittable, collective-aware like ``power_lipschitz``."""
    from ..ops import ztransform as Z

    def zproject(flat):
        vp = L.flat_to_padded(dp, flat)
        vp = tuple(
            jnp.where(Z.zmask(bk.mask) > 0, v, 0.0)
            for v, bk in zip(vp, dp.buckets)
        )
        return L.padded_to_flat(dp, vp)

    def apply_m(flat):
        vzp = L.flat_to_padded(dp, flat)
        dxp = tuple(
            Z.dz_forward_padded(v, bk.mask) for v, bk in zip(vzp, dp.buckets)
        )
        w = L.rmatvec_ps(dp, L.matvec_ps(dp, L.padded_to_flat(dp, dxp)))
        wp = L.flat_to_padded(dp, w)
        gzp = tuple(
            Z.dz_adjoint_padded(g, bk.mask) for g, bk in zip(wp, dp.buckets)
        )
        return L.padded_to_flat(dp, gzp)

    key = jax.random.PRNGKey(seed)
    if dp.col_axis:
        key = jax.random.fold_in(key, jax.lax.axis_index(dp.col_axis))
    v = zproject(jax.random.normal(key, (dp.n_pf,), dtype=dp.b.dtype))
    v = v / jnp.sqrt(jnp.maximum(L.xdot(dp, v, v), 1e-30))

    def body(_, carry):
        v, lam = carry
        w = apply_m(v)
        lam = jnp.sqrt(jnp.maximum(L.xdot(dp, w, w), 1e-30))
        return w / lam, lam

    _, lam = jax.lax.fori_loop(0, iters, body, (v, jnp.asarray(1.0, dp.b.dtype)))
    return lam * 1.05


def _get_solver(method: str):
    from . import apgd, frank_wolfe, lbfgs, mirror_descent, pgd

    table = {
        "pgd": pgd,
        "apgd": apgd,
        "fista": apgd,
        "lbfgs": lbfgs,
        "eg": mirror_descent,
        "mirror_descent": mirror_descent,
        "frank_wolfe": frank_wolfe,
        "fw": frank_wolfe,
        "afw": frank_wolfe,
        "pairwise": frank_wolfe,
        "pairwise_fw": frank_wolfe,
    }
    if method not in table:
        raise KeyError(f"unknown method {method!r}; options: {sorted(table)}")
    return table[method]


@partial(jax.jit, static_argnames=("opts", "solver_name", "steps"))
def _run_chunk(dp, state, L_est, opts: SolveOptions, solver_name: str, steps: int):
    solver = _get_solver(solver_name)
    state = solver.refresh(dp, state, L_est, opts)

    def body(st, _):
        st2 = solver.step(dp, st, L_est, opts)
        return st2, (st2.f, st2.gap)

    state, trace = jax.lax.scan(body, state, None, length=steps, unroll=opts.unroll)
    return state, trace


@partial(jax.jit, static_argnames=("opts", "solver_name", "steps"))
def _run_chunk_multi(dp, state, L_est, opts: SolveOptions, solver_name: str, steps: int):
    """Scenario-vmapped chunk (b of shape (S, m), state leaves lead with S)."""
    return jax.vmap(
        lambda b, st: _run_chunk(replace(dp, b=b), st, L_est, opts, solver_name, steps)
    )(dp.b, state)


# AOT chunk executables keyed by (static config, abstract arg signature):
# ``.lower().compile()`` bypasses jit's own cache, so without this every
# solve() call recompiles — the equality-constrained AL outer loop calls
# solve() once per outer on identical shapes and paid a full recompile each
# time (seconds per outer for the unrolled lbfgs graph).  Shared by the
# single-process and mesh-sharded drivers.
_AOT_CACHE: dict = {}
_AOT_CACHE_MAX = 64


def cached_executable(static_key, sig_args, build):
    """Memoise ``build()`` (a .lower().compile() closure) on ``static_key``
    plus the treedef + shape/dtype signature of ``sig_args``."""
    leaves, treedef = jax.tree_util.tree_flatten(sig_args)
    sig = tuple(
        (np.shape(leaf), str(getattr(leaf, "dtype", type(leaf).__name__)))
        for leaf in leaves
    )
    key = (static_key, treedef, sig)
    compiled = _AOT_CACHE.get(key)
    if compiled is None:
        compiled = build()
        if len(_AOT_CACHE) >= _AOT_CACHE_MAX:  # drop the oldest entry
            _AOT_CACHE.pop(next(iter(_AOT_CACHE)))
        _AOT_CACHE[key] = compiled
    return compiled


def _aot_chunk_executable(runner, dp, state, L_est, opts, method, chunk):
    return cached_executable(
        (runner is _run_chunk_multi, opts, method, chunk),
        (dp, state, L_est),
        lambda: runner.lower(dp, state, L_est, opts, method, chunk).compile(),
    )


def _polish_cg(dp, free_pf, g0t_pf, iters: int):
    """CG on the tangent-subspace normal equations: min_d 1/2||A d + r0||^2
    over d in T = {per-block free coords, zero-sum} — operator
    H = P A^T A P, rhs = -P g0 (P = tangent projection).  Everything stays
    fp32 at DELTA scale, which is the point: the correction d is O(gap)
    small, so fp32 resolves it to ~1e-7 RELATIVE to the gap, not to ||x||.
    """
    freep = L.flat_to_padded(dp, free_pf)

    def proj(v_flat):
        vp = L.flat_to_padded(dp, v_flat)
        outs = []
        for v, f in zip(vp, freep):
            cnt = jnp.sum(f, axis=-1, keepdims=True)
            mean = jnp.sum(v * f, axis=-1, keepdims=True) / jnp.maximum(cnt, 1.0)
            outs.append(jnp.where(f > 0, v - mean, 0.0))
        return L.padded_to_flat(dp, outs)

    def hmul(v_flat):
        return proj(L.rmatvec_ps(dp, L.matvec_ps(dp, v_flat)))

    b = proj(-g0t_pf)

    def body(carry, _):
        d, rr, p, rs = carry
        hp = hmul(p)
        denom = jnp.vdot(p, hp).real
        alpha = jnp.where(denom > 1e-30, rs / denom, 0.0)
        d = d + alpha * p
        rr = rr - alpha * hp
        rs_new = jnp.vdot(rr, rr).real
        beta = jnp.where(rs > 1e-30, rs_new / rs, 0.0)
        p = rr + beta * p
        return (d, rr, p, rs_new), None

    d0 = jnp.zeros_like(b)
    rs0 = jnp.vdot(b, b).real
    (d, *_), _ = jax.lax.scan(body, (d0, b, b, rs0), None, length=iters)
    return d


# module-level jits: refine_polish (and serving endpoints that call it per
# request) must hit the jit cache across calls — a fresh lambda per call
# would re-trace every time
@partial(jax.jit, static_argnums=3)
def _polish_cg_batch(dp, free_b, g0t_b, iters):
    return jax.vmap(lambda f, g: _polish_cg(dp, f, g, iters))(free_b, g0t_b)


@jax.jit
def _polish_inject_batch(dp, g_b):
    return jax.vmap(lambda g: L.inject_user_grad(dp, g))(g_b)


@jax.jit
def _polish_extract_batch(dp, d_b):
    return jax.vmap(lambda d: L.extract_user_flat(dp, L.flat_to_padded(dp, d)))(d_b)


def refine_polish(problem: Problem, dp, res: "SolveResult", rounds: int = 3,
                  cg_iters: int = 30,
                  target_rel_gap: float | None = None) -> "SolveResult":
    """Active-set tangent-space polish (fp32 iterative refinement).

    fp32 floors the true (f64-evaluated) relative objective gap at ~2e-6
    to ~1e-5 on medium-scale instances — NOT because the solvers stall
    (f64 runs reach 3e-13 in the same iterations) but because near the
    optimum every fp32 update smaller than eps*|x| rounds away.  The polish
    solves for the CORRECTION instead, per round:

      1. anchor in f64 on the host: r0 = A x - b, g0 = A^T r0;
      2. free set = {x > 0} plus pinned coords whose reduced gradient
         wants them positive (multiplier release test);
      3. truncated CG on the tangent-subspace normal equations ON DEVICE
         (fp32 at DELTA scale, where fp32 has full relative precision;
         the subspace projection is a per-block masked mean — no simplex
         projection in the loop);
      4. backtracked clipped step chosen by the f64 host objective
         (t = 1, 1/2, ... — first improvement wins), clip + renormalise
         in f64.

    A wrong active set or an already-optimal x degrades to a no-op (the
    backtracking accepts only f64-objective improvements).  A few rounds
    (~30 CG iterations each, each the cost of one solver iteration) take
    an lbfgs fp32 plateau below 1e-6 relative.  Rounds needed scale with how demanding the relative target is: medium-scale
    instances cross 1e-6 in 2-3 rounds; the tiny config (f* ~ 1e-4, so
    relative gaps are ~100x harder in absolute terms) takes ~8 rounds to
    1e-12.  Rounds after convergence are cheap no-ops (first rejected
    backtrack exits).

    ``target_rel_gap``: certified adaptive mode.  Each round's f64 anchor
    already pays for the gradient, so the float64 Frank-Wolfe duality gap
    (a SOUND bound: f - f* <= gap, no oracle needed) is computed for free;
    the polish stops as soon as every scenario's gap / max(1, |f|) is at
    or below the target, and the certificate ships on the result as
    ``refine_fw_gap`` (worst scenario).  ``rounds`` becomes the cap.

    ``dp=None``: host-only mode — the CG correction runs on the host in
    float64 instead of on device (used for mesh-sharded results, which are
    gathered before polishing; no single-device DeviceProblem exists).
    """
    t_start = time.perf_counter()
    from ..models.oracle import _fast_operator

    op = _fast_operator(problem.A)  # CSR matvecs: the EllMatrix host
    # bincount path is ~10x slower and the polish does hundreds of them

    def _mm(Xm):  # (S, n) -> (S, m)
        if hasattr(op, "matmat"):
            return op.matmat(Xm)
        return np.stack([op.matvec(v) for v in Xm])

    def _rmm(Rm):  # (S, m) -> (S, n)
        if hasattr(op, "rmatmat"):
            return op.rmatmat(Rm)
        return np.stack([op.rmatvec(v) for v in Rm])

    part = problem.partition
    sizes = part.sizes
    offsets = np.concatenate([[0], np.cumsum(sizes)])[:-1]
    multi = np.asarray(res.x).ndim == 2

    def repair(V):  # (S, N) or (N,): clip + per-block renormalise in f64
        V = np.maximum(V, 0.0)
        s = np.add.reduceat(V, offsets, axis=-1)
        return V / np.repeat(np.maximum(s, 1e-300), sizes, axis=-1)

    X = repair(np.atleast_2d(np.asarray(res.x, np.float64)))
    B = np.atleast_2d(np.asarray(problem.b, np.float64))
    S = X.shape[0]

    def obj_s(v, s):
        r = op.matvec(v) - B[s]
        return 0.5 * float(r @ r)

    F = np.array([obj_s(X[s], s) for s in range(S)])
    it_extra = 0
    # certified mode always corrects on the host: the f64 Jacobi-PCG is
    # what makes the certificate tight (the fp32-delta device CG floors
    # the FW gap above 1e-6 on medium), while plain refine=K keeps the
    # device path (same objective quality).  BSLS_REFINE_HOST=1 forces the
    # host path for plain refine too: at config-4 scale (8M vars) 30
    # fp32-delta device iterations resolve almost nothing of the face,
    # while the host f64 PCG is what the certified reference's quality
    # comes from.
    use_host = (dp is None or target_rel_gap is not None
                or os.environ.get("BSLS_REFINE_HOST") == "1")
    if dp is not None:
        perm_h = np.asarray(dp.perm)
        sel = perm_h >= 0
    if use_host:
        from ..ops.layout import _col_norms_sq
        from ..utils.hostops import host_matmat_ops

        _coln = _col_norms_sq(problem.A)  # diag(A^T A): Jacobi preconditioner
        _nat = host_matmat_ops(problem.A)  # OpenMP SpMM (scipy fallback)
        if _nat is not None:
            _mm, _rmm = _nat
    cert = None  # f64 FW-gap certificate of the CURRENT X (relative, worst s)
    from ..models.oracle import fw_gap_np as _fwgap

    # certified mode needs enough CG to resolve the face: 30 device
    # iterations suffice for the 1e-12 objective but not for a tight
    # certificate, and when a round's steps are all rejected the budget
    # escalates (doubling, capped) instead of giving up — the remaining
    # FW gap lives in near-null face directions that barely move f.
    # Two cheaper schedules were A/B'd round 5 and are measured
    # negatives: a small (50) start with escalate-on-stall ends at MORE
    # total CG than flat 200 (45.5 s vs 38.5 s on medium x32), and
    # adding escalate-on-stall to the flat 200 start doubles rounds
    # early and nearly doubles wall (72 s) — the FW certificate needs
    # the deep rounds regardless, so the flat schedule wins.
    cg_now = cg_iters if target_rel_gap is None else max(cg_iters, 200)
    cg_cap = max(cg_now, 1600)
    # per-scenario convergence mask: certified scenarios drop out of the
    # host PCG and step phases (measured medium x32: most scenarios
    # certify in the first rounds — without masking every round pays the
    # full 32-wide SpMM train for a shrinking set of stragglers)
    active = np.ones(S, bool)
    # incremental anchors: a scenario's
    # f64 anchor pair (r0, g0) and certificate only change when a step
    # moved ITS iterate, so frozen/rejected scenarios keep last round's —
    # the per-round SpMM train shrinks to the stragglers instead of
    # re-paying the full S-wide anchor every round
    G0 = np.zeros_like(X)
    certv = np.full(S, np.inf)
    stale = np.ones(S, bool)
    _rtrace = os.environ.get("BSLS_REFINE_TRACE") == "1"
    for _round_i in range(rounds):
        _t_round = time.perf_counter()
        idxn = np.nonzero(stale)[0]
        if idxn.size:
            G0[idxn] = _rmm(_mm(X[idxn]) - B[idxn])
            stale[idxn] = False
        g0 = G0
        if target_rel_gap is not None:
            for s in idxn:
                # two sound bounds on F[s] - f*: the f64 FW duality gap,
                # and F[s] itself (least squares: f* >= 0).  The second
                # matters on underdetermined configs (config 4 fits to
                # ~1e-5 where the FW gap stays loose by orders)
                certv[s] = (min(_fwgap(G0[s], X[s], sizes), F[s])
                            / max(1.0, abs(F[s])))
            cert = float(certv.max())
            active = certv > target_rel_gap
            if not active.any():
                break
        free = (X > 1e-12).astype(np.float64)
        cnt = np.maximum(np.add.reduceat(free, offsets, axis=-1), 1.0)
        lam = np.repeat(np.add.reduceat(g0 * free, offsets, axis=-1) / cnt,
                        sizes, axis=-1)
        free = np.maximum(
            free, ((free == 0) & (g0 < lam - 1e-12)).astype(np.float64))
        # tangent-project g0 in f64 BEFORE the fp32 cast: the cast error
        # then scales with the remaining optimality gap, not with ||g||
        cnt = np.maximum(np.add.reduceat(free, offsets, axis=-1), 1.0)
        gsum = np.add.reduceat(g0 * free, offsets, axis=-1)
        g0t = (g0 - np.repeat(gsum / cnt, sizes, axis=-1)) * free
        if use_host:
            # host float64 Jacobi-PCG on the same tangent-subspace normal
            # equations (P A^T A P d = -P g0).  Used when no single-device
            # DeviceProblem exists — mesh-sharded results are gathered to
            # the host and polished here; batched over scenarios with
            # per-scenario CG scalars.  f64 throughout, so the correction
            # is exact to the face (the device path resolves it to fp32 at
            # delta scale).  The diag(A^T A) preconditioner is the
            # certificate lever: on medium-scale instances it tightens the
            # f64 FW-gap certificate by orders of magnitude at the same
            # 200-iteration CG budget, which is what lets refine_tol=1e-6
            # CERTIFY instead of capping out.
            # Row-major (S', n) working set with the native OpenMP SpMM.
            # A column-major (n, S') rewrite with sparse-indicator
            # blocksum/scatter was built and A/B'd solo (round 5) and is
            # a measured NEGATIVE on medium x32 — the scipy column-form CSR
            # products lose to the native row-major batched kernel by more
            # than the transpose/reduceat overhead they save.  Two cheaper
            # CG schedules (50-start ladder, escalate-on-cert-stall) also
            # measured slower; the flat 200 schedule stays.
            idx = np.nonzero(active)[0]
            freea, cnta, g0ta = free[idx], cnt[idx], g0t[idx]

            def tproj(V):
                V = V * freea
                sm = np.add.reduceat(V, offsets, axis=-1)
                return (V - np.repeat(sm / cnta, sizes, axis=-1)) * freea

            # Preconditioner: diagonal Jacobi.  An exact per-block
            # tangent-space KKT (block-Jacobi) preconditioner was built and
            # A/B'd (round 4): rz decay was IDENTICAL (~3.5 decades / 10
            # iterations, both exit at ~80) and wall time 31% WORSE from
            # the per-round batched (w+1)x(w+1) factorizations — on
            # equilibrated instances the within-block curvature is already
            # captured by the diagonal; the PCG is limited by cross-block
            # coupling (a negative result).
            Minv = freea / np.maximum(_coln[None, :], 1e-30)

            def prec(V):
                # V (the CG residual) stays in the tangent space by the
                # projected-CG invariants, so one projection after the
                # diagonal scaling suffices — the inner tproj(V) and the
                # pre-H tproj(Pd) were measured as ~40% of certified x32
                # polish wall time and are redundant in exact arithmetic
                return tproj(Minv * V)

            Da = np.zeros_like(g0ta)
            R = -g0ta  # g0t = P g0 already
            Z = prec(R)
            Pd = Z.copy()
            rz = np.einsum("sn,sn->s", R, Z)
            rz0 = rz.copy()
            _trace = os.environ.get("BSLS_PCG_TRACE") == "1"
            for _cg_k in range(cg_now):
                _ratio = float(np.max(rz / np.maximum(rz0, 1e-300)))
                if _trace and _cg_k % 10 == 0:
                    print(f"    pcg it={_cg_k} max rz/rz0={_ratio:.3e}",
                          flush=True)
                if _ratio <= 1e-28:
                    break
                HP = tproj(_rmm(_mm(Pd)))
                den = np.einsum("sn,sn->s", Pd, HP)
                alpha = np.where(den > 1e-300, rz / np.maximum(den, 1e-300), 0.0)
                Da += alpha[:, None] * Pd
                R -= alpha[:, None] * HP
                Z = prec(R)
                rz_new = np.einsum("sn,sn->s", R, Z)
                beta = np.where(rz > 1e-300, rz_new / np.maximum(rz, 1e-300), 0.0)
                Pd = Z + beta[:, None] * Pd
                rz = rz_new
            D = np.zeros_like(g0t)
            D[idx] = Da
        else:
            free_pf = np.where(sel[None], free[:, np.maximum(perm_h, 0)], 0.0)
            g0t_pf = _polish_inject_batch(dp, jnp.asarray(g0t, jnp.float32))
            d_pf = _polish_cg_batch(dp, jnp.asarray(free_pf, jnp.float32),
                                    g0t_pf, cg_iters)
            D = np.asarray(_polish_extract_batch(dp, d_pf), np.float64)
        it_extra += cg_now if use_host else cg_iters
        # per-scenario backtracked clipped step, f64 objective decides
        any_accepted = False
        for s in range(S):
            if not active[s]:
                continue  # already certified: frozen
            t = 1.0
            for _k in range(24):
                xc = repair(X[s] + t * D[s])
                fc = obj_s(xc, s)
                if fc < F[s]:
                    X[s], F[s] = xc, fc
                    any_accepted = True
                    stale[s] = True  # anchor + certificate now outdated
                    break
                t *= 0.5
        if not any_accepted:
            if (target_rel_gap is not None and cert is not None
                    and cert > target_rel_gap and cg_now < cg_cap):
                cg_now = min(2 * cg_now, cg_cap)
                continue
            break
        if _rtrace:
            print(f"[refine] round={_round_i} active={int(active.sum())}"
                  f"/{S} cg={cg_now} cert={cert} "
                  f"secs={time.perf_counter() - _t_round:.2f}", flush=True)
    if target_rel_gap is not None:
        # certify the final iterate: refresh only moved scenarios' anchors
        idxn = np.nonzero(stale)[0]
        if idxn.size:
            G0[idxn] = _rmm(_mm(X[idxn]) - B[idxn])
            for s in idxn:
                certv[s] = (min(_fwgap(G0[s], X[s], sizes), F[s])
                            / max(1.0, abs(F[s])))
        cert = float(certv.max())
    return SolveResult(
        x=X if multi else X[0],
        objective=np.asarray(F if multi else F[0]),
        gap=res.gap,
        iterations=res.iterations + it_extra,
        converged=res.converged,
        trace_f=res.trace_f,
        trace_gap=res.trace_gap,
        chunk_times=res.chunk_times,
        chunk_iters=res.chunk_iters,
        stop_reason=res.stop_reason,
        refine_secs=time.perf_counter() - t_start,
        refine_fw_gap=cert,
    )


def solve(
    problem: Problem | L.DeviceProblem,
    method: str = "pgd",
    tol: float = 1e-6,
    max_iter: int = 10_000,
    chunk: int = 100,
    line_search: str = "exact",
    step_size: float = 0.0,
    space: str = "x",
    unroll: int = 1,
    dtype=jnp.float32,
    callback: Optional[Callable[[int, Any], None]] = None,
    mesh=None,
    verbose: bool = False,
    x0: Optional[np.ndarray] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    checkpoint_keep: int = 0,
    resume: bool = False,
    metrics=None,
    stop_rule: str = "auto",
    certify: int = 0,
    lipschitz: Optional[float] = None,
    lbfgs_mem: int = 8,
    refine: int = 0,
    refine_tol: Optional[float] = None,
) -> SolveResult:
    """Solve a block-simplex LSQ instance (single-process entry point).

    Multi-RHS problems (b of shape (S, m)) are vmapped over scenarios.
    For mesh-sharded solves, pass ``mesh`` (see bsls_tpu.parallel).

    ``refine=K`` runs K active-set tangent-space polish rounds after the
    main solve (single- or multi-RHS; unconstrained; requires a host
    ``Problem``): the correction to the fp32 solution is CG-solved on
    device at DELTA scale and accumulated in float64 on the host — see
    ``refine_polish``.  Mesh-sharded solves refine too: the sharded result
    is gathered and polished with the host float64 CG path (dp=None).
    Plain fp32 floors the true (f64-evaluated) relative objective gap at
    ~2e-6..1e-5 on medium-scale instances; a few polish rounds push
    through 1e-6.  The returned ``x``
    is float64 and ``objective`` is its f64 value.  ``refine_tol`` makes
    the polish adaptive AND certified: rounds stop as soon as the float64
    FW duality gap certifies every scenario to the target relative gap
    (``refine`` caps the rounds; when ``refine_tol`` is given alone the
    cap defaults to 16 rounds instead of silently skipping the polish),
    and the certificate is returned as ``res.refine_fw_gap``.

    ``lipschitz`` skips the on-device power iteration and uses the given
    ||A||_2^2 bound for the 1/L trial step (the augmented-Lagrangian outer
    loop updates it analytically across penalty changes).

    ``certify=K`` runs K pairwise-FW polish steps after the main solve to
    tighten the duality-gap certificate (orders of magnitude at equal or
    better objective); the returned ``gap`` is then a tight sound bound
    f(x) - f* <= gap.
    """
    if isinstance(problem, Problem) and problem.C is not None:
        from .eq_constrained import solve_equality_constrained

        # the AL outer loop supports a subset of solve()'s surface — reject
        # the rest loudly instead of silently ignoring it (metrics,
        # checkpointing, and resume ARE supported: the AL loop checkpoints
        # its host-side state at outer granularity)
        unsupported = {
            "space": space != "x", "callback": callback is not None,
            "certify": certify > 0,
            "lipschitz": lipschitz is not None,
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise ValueError(
                f"equality-constrained solve does not support {bad}; run the "
                "AL loop manually via solvers.eq_constrained if needed"
            )
        return solve_equality_constrained(
            problem, method=method, tol=tol, max_iter=max_iter, chunk=chunk,
            line_search=line_search, step_size=step_size, dtype=dtype, mesh=mesh,
            unroll=unroll, lbfgs_mem=lbfgs_mem, x0=x0, refine=refine,
            refine_tol=refine_tol, metrics=metrics,
            checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
            checkpoint_keep=checkpoint_keep, resume=resume,
        )
    if refine_tol is not None and refine == 0:
        # certified mode with no explicit round cap: default the cap to 16
        # rounds instead of silently ignoring refine_tol (eq solves above
        # treat refine_tol as standalone — there the certificate is an AL
        # dual bound, not a polish loop, so no cap is needed)
        refine = 16
    if mesh is not None:
        from ..parallel.sharding import solve_sharded

        if callback is not None:
            raise ValueError("callback is not supported for mesh-sharded solves")
        if space != "x":
            raise ValueError("mesh-sharded solves support space='x' only")
        if refine > 0 and not isinstance(problem, Problem):
            raise ValueError(
                "refine on a mesh-sharded solve needs the host Problem (the "
                "polish anchor is a host float64 pass); pass the Problem, "
                "not a pre-sharded triple"
            )
        res = solve_sharded(
            problem, mesh, method=method, tol=tol, max_iter=max_iter,
            chunk=chunk, line_search=line_search, step_size=step_size, dtype=dtype,
            x0=x0, verbose=verbose, metrics=metrics,
            checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
            checkpoint_keep=checkpoint_keep, resume=resume, stop_rule=stop_rule,
            lbfgs_mem=lbfgs_mem,
        )
        if refine > 0:
            # gather-and-polish: the sharded result is already host-side
            # (extract_sharded); the host f64 CG path (dp=None) runs the
            # same tangent-space correction the single-device polish does
            res = refine_polish(problem, None, res, rounds=refine,
                                target_rel_gap=refine_tol)
        return res
    if isinstance(problem, Problem):
        dp = L.prepare(problem, dtype=dtype)
    else:
        dp = problem

    opts = SolveOptions(
        method=method, line_search=line_search, tol=tol,
        max_iter=max_iter, chunk=chunk, step_size=step_size, space=space,
        unroll=unroll, lbfgs_mem=lbfgs_mem,
    )
    solver = _get_solver(method)
    multi = dp.b.ndim == 2

    if lipschitz is not None:
        L_est = jnp.asarray(lipschitz, dp.b.dtype)
    else:
        # z-space solvers need the z-parametrisation's curvature ||A D||^2
        # for their trial step, not ||A||^2 (see uses_zspace)
        power = (
            power_lipschitz_z if uses_zspace(method, line_search, space)
            else power_lipschitz
        )
        L_est = power(dp if not multi else replace(dp, b=dp.b[0]))

    if x0 is not None:
        x0j = jnp.asarray(x0, dtype)
        if multi:
            xp0 = jax.vmap(lambda xx: L.inject_user_flat(dp, xx))(x0j)
        else:
            xp0 = L.inject_user_flat(dp, x0j)
    else:
        xp0 = None

    if multi:
        if xp0 is None:
            state = jax.vmap(lambda b: solver.init(replace(dp, b=b), L_est, opts))(dp.b)
        else:
            state = jax.vmap(
                lambda b, xx: solver.init(replace(dp, b=b), L_est, opts, xp0=xx)
            )(dp.b, xp0)
        runner = _run_chunk_multi
    else:
        state = solver.init(dp, L_est, opts, xp0=xp0)
        runner = _run_chunk

    # AOT-compile the chunk executable so XLA compile time never lands in
    # chunk_times[0] (time_to_gap interpolates over the wall trace)
    compiled = _aot_chunk_executable(runner, dp, state, L_est, opts, method, chunk)
    run = lambda st: compiled(dp, st, L_est)

    it = 0
    if resume and checkpoint_path:
        from ..utils.checkpoint import latest_checkpoint, load_state

        ck = latest_checkpoint(checkpoint_path)
        if ck:
            state, meta = load_state(ck, state)
            it = int(meta.get("iteration", 0))

    # Chunk loop with ASYNC dispatch + adaptive sync cadence.  Host
    # readbacks between chunks stall the device, and on small configs they
    # can dominate the true compute entirely.  So: chunks are enqueued without blocking, per-chunk (f, gap) traces stay on
    # device until the end (one batched transfer), and convergence stats come
    # back in ONE packed transfer every `sync_every` chunks, where
    # `sync_every` adapts so readback overhead stays ~5% of compute.  The
    # packed read carries the END-OF-CHUNK (f, gap) of every chunk in the
    # interval, and the stopper replays them chunk by chunk — stopping
    # SEMANTICS are identical to the fully-synchronous loop; only the
    # decision arrives up to sync_every chunks late (the extra chunks are
    # already-enqueued cheap compute; ``iterations`` reports the
    # criterion-hit point, while x/objective use the final — at least as
    # converged — state).
    traces_f, traces_g, ctimes, citers = [], [], [], []
    converged = False
    stopper = StopTracker(tol, stop_rule)
    chunks_done = 0
    sync_every, since_sync = 1, 0
    # tol>0: bound the stop-decision lag; tol<=0 runs the full budget anyway
    max_sync = MAX_SYNC_CHUNKS if tol <= 0 else MAX_SYNC_CHUNKS_TOL
    # per-chunk host work (checkpoint/callback/verbose) forces per-chunk sync
    eager_host = bool(callback is not None or verbose
                      or (checkpoint_path and checkpoint_every))
    # chunk executable AOT-compiled above: compile is outside the timed region
    t0 = time.perf_counter()
    while it < max_iter:
        state, (tf, tg) = run(state)
        it += chunk
        chunks_done += 1
        since_sync += 1
        traces_f.append(tf)
        traces_g.append(tg)
        if since_sync < sync_every and it < max_iter and not eager_host:
            continue
        citers.append(it)
        # one packed transfer: end-of-chunk (f, gap) for every chunk in the
        # interval; forces completion of everything queued so far
        k_sync = min(since_sync, MAX_SYNC_CHUNKS)
        fg = np.asarray(pack_chunk_stats(traces_f, traces_g, k_sync,
                                         state.f.dtype))
        t1 = time.perf_counter()
        ctimes.append(t1 - t0)
        t0 = t1
        stop_at = None
        for j in range(k_sync):
            f_j = fg[0, j] if multi else fg[0, j, 0]
            rel_j = (fg[1, j] if multi else fg[1, j, 0]) / np.maximum(
                1.0, np.abs(f_j))
            if stopper.update(f_j, rel_j):
                stop_at = j
                break
        f_last = fg[0, -1] if multi else fg[0, -1, 0]
        gap_last = fg[1, -1] if multi else fg[1, -1, 0]
        rel = gap_last / np.maximum(1.0, np.abs(f_last))
        if metrics is not None:
            metrics.log(
                "chunk", iteration=it, f=f_last.tolist(), relgap=rel.tolist(),
                secs=ctimes[-1],
            )
        if checkpoint_path and checkpoint_every and chunks_done % checkpoint_every == 0:
            from ..utils.checkpoint import save_state

            save_state(checkpoint_path, state, meta={"iteration": it}, keep=checkpoint_keep)
        if callback is not None:
            callback(it, state)
        if verbose:
            print(f"iter {it}: f={f_last} relgap={rel}")
        if stop_at is not None:
            converged = True
            # report the criterion-hit iteration (the chunks enqueued past it
            # still ran and their — at least as converged — state is kept)
            it -= (k_sync - 1 - stop_at) * chunk
            break
        # adapt the sync cadence: SYNC_TARGET_SECS of enqueued compute
        # between syncs
        chunk_wall = ctimes[-1] / since_sync
        sync_every = int(np.clip(round(SYNC_TARGET_SECS / max(chunk_wall, 1e-6)),
                                 1, max_sync))
        since_sync = 0
    if checkpoint_path and checkpoint_every:
        from ..utils.checkpoint import save_state

        save_state(checkpoint_path, state, meta={"iteration": it}, keep=checkpoint_keep)

    certified_gap = None
    if certify and method not in ("afw", "pairwise", "pairwise_fw"):
        # certificate polish: a short pairwise-FW phase from the current
        # iterate.  The FW duality gap g.(x-s) is sound but loose at a
        # PGD-family iterate (residual mass on suboptimal coordinates
        # inflates it by orders of magnitude); pairwise transfers drain
        # exactly those coordinates, so ~100 afw steps tighten the
        # certificate by orders of magnitude at equal-or-better objective.
        from . import frank_wolfe as _fw

        opts_c = SolveOptions(
            method="afw", line_search="exact", tol=0.0,
            max_iter=certify, chunk=certify, unroll=opts.unroll,
        )
        if multi:
            state_c = jax.vmap(
                lambda b, xx: _fw.init(replace(dp, b=b), L_est, opts_c, xp0=xx)
            )(dp.b, state.xp)
            state_c, _ = _run_chunk_multi(dp, state_c, L_est, opts_c, "afw", certify)
        else:
            state_c = _fw.init(dp, L_est, opts_c, xp0=state.xp)
            state_c, _ = _run_chunk(dp, state_c, L_est, opts_c, "afw", certify)
        f_c = np.asarray(state_c.f)
        better = f_c <= np.asarray(state.f) + 1e-12
        if bool(np.all(better)):
            state = state._replace(xp=state_c.xp, r=state_c.r, f=state_c.f,
                                   gap=state_c.gap)
        certified_gap = np.asarray(state_c.gap)

    axis = 1 if multi else 0
    if not traces_f:  # resumed past max_iter: nothing ran this call
        empty = np.zeros((dp.b.shape[0], 0) if multi else (0,), np.float32)
        trace_f, trace_gap = empty, empty
    else:
        # traces lived on device during the loop; concatenate there and pay
        # ONE host transfer for each of the two traces
        trace_f = np.asarray(jnp.concatenate(traces_f, axis=axis))
        trace_gap = np.asarray(jnp.concatenate(traces_g, axis=axis))
    # one final exact projection: guarantees bit-level feasibility of the
    # returned x regardless of method (the z-space path can leave O(eps)
    # negative entries after the z->x difference map)
    from ..ops.projection import proj_blocks

    if multi:
        xp = jax.vmap(lambda p: proj_blocks(p, dp.buckets))(state.xp)
        x = np.asarray(jax.vmap(lambda p: L.extract_user_flat(dp, p))(xp))
    else:
        xp = proj_blocks(state.xp, dp.buckets)
        x = np.asarray(L.extract_user_flat(dp, xp))
    res = SolveResult(
        x=x,
        objective=np.asarray(state.f),
        gap=np.asarray(state.gap),
        iterations=it,
        converged=converged,
        trace_f=trace_f,
        trace_gap=trace_gap,
        chunk_times=np.asarray(ctimes),
        chunk_iters=np.asarray(citers),
        stop_reason=stopper.reason,
    )
    if refine > 0:
        if not isinstance(problem, Problem):
            raise ValueError(
                "refine requires a host Problem (the correction anchor is "
                "re-evaluated in float64 on the host)"
            )
        res = refine_polish(problem, dp, res, rounds=refine,
                            target_rel_gap=refine_tol)
    return res
