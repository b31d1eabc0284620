"""Serving endpoint: prepare and compile once, answer many solve requests.

Production deployments hold a fixed incidence matrix A (the road network)
and answer a stream of right-hand sides b (new sensor readings, scenario
batches).  ``Endpoint`` front-loads all per-instance work — PF layout,
equilibration, dual-ELL encoding, Lipschitz estimate, XLA compilation —
so each request is a warm chunked solve on-device (BASELINE.json frames the
framework as production route-flow estimation; the reference has no serving
story, SURVEY.md §5 [ABSENT]).

    ep = Endpoint(problem, method="apgd", chunk=200)
    ep.warmup()                       # optional: compile before traffic
    res = ep.solve(b_new, tol=1e-6)   # same shapes -> no recompilation
    res = ep.solve(B_batch)           # (S, m) batches are first-class

A request whose b has a new shape (different S) triggers one compile for
that shape and is cached thereafter (jax jit cache keyed on shapes).
"""
from __future__ import annotations

from dataclasses import replace
from typing import Optional

import jax.numpy as jnp
import numpy as np

from .models.problem import Problem
from .ops import layout as L
from .solvers.base import SolveResult, solve

__all__ = ["Endpoint", "BatchQueue"]


class Endpoint:
    def __init__(
        self,
        problem: Problem,
        method: str = "apgd",
        line_search: str = "exact",
        chunk: int = 200,
        dtype=jnp.float32,
        equilibrate: bool = True,
        warm_start: bool = True,
        mesh=None,
    ):
        # cold-start is almost entirely XLA compile time; the persistent
        # cache replays it across process restarts
        from .utils.compile_cache import enable_compile_cache

        enable_compile_cache()
        self.method = method
        self.line_search = line_search
        self.chunk = chunk
        self.dtype = dtype
        self.warm_start = warm_start
        self.mesh = mesh
        self._problem = problem
        self._eq = problem.C is not None
        if mesh is not None and self._eq:
            # eq-constrained pod serving: the AL loop's op_cache holds the
            # SHARDED stacked [A; sqrt(rho) C] operator after the first
            # request (one shard/upload + two on-mesh power iterations);
            # streaming requests re-upload only the stacked RHS.  Warm
            # multipliers come from the _eq_warm cache like the single-chip
            # path.
            self._eq_warm = {}
            self._eq_ops = {}
            self._dp = None
            self._row_perm = None
            self._m = problem.A.shape[0]
            return
        if mesh is not None:
            # pod-sharded serving: shard/upload A once, stream only b —
            # per-request work is one small device_put + a cached executable
            from .parallel.sharding import shard_problem

            import jax
            from jax.sharding import NamedSharding, PartitionSpec as P

            dp, part = shard_problem(problem, mesh, dtype=dtype,
                                     equilibrate=equilibrate)
            self._sharded = (dp, part)
            self._b_sharding = NamedSharding(mesh, P("scenario", None))
            # the sharded prepare never row-buckets/pads (col_axis forces
            # row_bucket off), so requests use b verbatim
            assert dp.row_perm is None
            self._m = problem.A.shape[0]
            # ||A||^2 depends only on A: one on-mesh power iteration at init
            from .parallel.sharding import dp_specs
            from .solvers.base import power_lipschitz

            lips = jax.jit(jax.shard_map(
                power_lipschitz, mesh=mesh, in_specs=(dp_specs(dp),),
                out_specs=P()))
            self._lip = float(lips(dp))
            self._dp = None
            return
        # warm-multiplier cache for eq-constrained streams: converged AL
        # state (lam, rho, x) of the last request, keyed by batch shape so
        # each compiled width bucket warm-starts from its own kin
        self._eq_warm: dict = {}
        # prepared-operator cache shared across requests: the stacked
        # [A; sqrt(rho) C] encoding and its Lipschitz constants depend only
        # on the instance, so streaming requests skip re-prepare entirely
        self._eq_ops: dict = {}
        if self._eq:
            # equality-constrained: the augmented-Lagrangian outer loop
            # rebuilds the stacked operator per outer iteration, so the
            # endpoint holds the host problem; inner chunk executables are
            # shape-stable across requests and reuse the jit cache
            self._dp = None
            self._row_perm = None
        else:
            self._dp = L.prepare(problem, dtype=dtype, equilibrate=equilibrate)
            self._row_perm = (
                None if self._dp.row_perm is None else np.asarray(self._dp.row_perm)
            )
        self._m = problem.A.shape[0]

    @property
    def num_rows(self) -> int:
        return self._m

    def _with_b(self, b: np.ndarray):
        b = np.asarray(b, dtype=np.float32)
        if b.shape[-1] != self._m:
            raise ValueError(f"b last dim {b.shape[-1]} != m={self._m}")
        if self._row_perm is not None:
            b = b[..., self._row_perm]  # match the row-nnz-bucketed layout
        return replace(self._dp, b=jnp.asarray(b, self.dtype))

    def solve(
        self,
        b: np.ndarray,
        tol: float = 1e-6,
        max_iter: int = 10_000,
        x0: Optional[np.ndarray] = None,
        **kw,
    ) -> SolveResult:
        """Solve against a new right-hand side (or (S, m) batch)."""
        if self._eq:
            from dataclasses import replace as dc_replace

            from .solvers.eq_constrained import solve_equality_constrained

            b = np.asarray(b, dtype=np.dtype(jnp.dtype(self.dtype).name))
            if b.shape[-1] != self._m:
                raise ValueError(f"b last dim {b.shape[-1]} != m={self._m}")
            prob = dc_replace(self._problem, b=b)
            warm = self._eq_warm.get(b.shape[:-1]) if self.warm_start else None
            # Sensitivity fast path (streaming requests): from the previous
            # request's CONVERGED x, run warm-started block principal
            # pivoting in float64 on the host — no fp32 inner solves at
            # all.  Certificate-gated: a None return (instance too large
            # for host matvecs, round cap, or final violation above tol)
            # falls through to the full AL solve.  Opt out per request
            # with sensitivity=False (e.g. when consecutive b's are NOT
            # near each other).
            sens = kw.pop("sensitivity", True)
            # mesh-backed endpoints fast-path too (round 5): the BPP walk
            # runs on the HOST from the gathered warm iterate — no sharded
            # state is touched, and a None return still falls through to
            # the full (sharded) AL solve
            if (sens and warm is not None and x0 is None
                    and "rho" in warm):
                from .solvers.eq_constrained import solve_eq_sensitivity

                fast = solve_eq_sensitivity(
                    prob, warm["x"], rho=warm["rho"],
                    eq_tol=kw.get("eq_tol", tol),
                )
                if fast is not None:
                    self._eq_warm[b.shape[:-1]] = {
                        "lam": fast.eq_lam, "rho": fast.eq_rho,
                        "x": np.asarray(fast.x),
                    }
                    return fast
            if warm is not None and x0 is None:
                # warm-start lam and x but NOT the grown rho: with lam near
                # the optimal multipliers a small penalty already satisfies
                # the constraints, while a large rho ill-conditions the
                # stacked operator and slows every inner solve (warm rho
                # made requests slower than cold)
                kw.setdefault("lam0", warm["lam"])
                kw.setdefault("x0", warm["x"])
            elif x0 is not None:
                kw.setdefault("x0", x0)
            res = solve_equality_constrained(
                prob, method=self.method, tol=tol, max_iter=max_iter,
                chunk=self.chunk, line_search=self.line_search,
                dtype=self.dtype, op_cache=self._eq_ops, mesh=self.mesh, **kw,
            )
            if self.warm_start and res.converged:
                self._eq_warm[b.shape[:-1]] = {
                    "lam": res.eq_lam, "rho": res.eq_rho, "x": np.asarray(res.x),
                }
            return res
        if self.mesh is not None:
            import jax

            from dataclasses import replace as dc_replace

            from .parallel.sharding import solve_sharded

            # refine on the pod-sharded endpoint: solve sharded, then
            # gather-and-polish against the host Problem with this
            # request's b (the host f64 CG path — same as
            # solve(mesh=..., refine=K))
            refine = int(kw.pop("refine", 0))
            refine_tol = kw.pop("refine_tol", None)
            if refine_tol is not None and refine <= 0:
                refine = 16  # refine_tol alone must not silently skip the
                # polish — mirror solve()'s default round cap (base.py)
            b = np.asarray(b, dtype=np.dtype(jnp.dtype(self.dtype).name))
            single = b.ndim == 1
            if single:
                b = b[None, :]
            if b.shape[-1] != self._m:
                raise ValueError(f"b last dim {b.shape[-1]} != m={self._m}")
            ns = dict(self.mesh.shape).get("scenario", 1)
            if b.shape[0] % ns:
                raise ValueError(
                    f"batch width {b.shape[0]} not divisible by the mesh's "
                    f"scenario axis ({ns}); pad the batch or use scenario=1"
                )
            dp, part = self._sharded
            dp_b = dc_replace(dp, b=jax.device_put(
                jnp.asarray(b, self.dtype), self._b_sharding))
            res = solve_sharded(
                (dp_b, part, single), self.mesh, method=self.method,
                line_search=self.line_search, tol=tol, max_iter=max_iter,
                chunk=self.chunk, dtype=self.dtype, x0=x0,
                lipschitz=self._lip, **kw,
            )
            if refine > 0:
                from .solvers.base import refine_polish

                prob = dc_replace(
                    self._problem,
                    b=np.asarray(b[0] if single else b, np.float64))
                res = refine_polish(prob, None, res, rounds=refine,
                                    target_rel_gap=refine_tol)
            return res
        # refine needs the host Problem (f64 anchor) — run the polish here,
        # against this request's b, instead of inside solve(dp) which only
        # sees the DeviceProblem.  The polish reuses its jitted CG across
        # requests of the same batch width.
        refine = int(kw.pop("refine", 0))
        refine_tol = kw.pop("refine_tol", None)
        if refine_tol is not None and refine <= 0:
            refine = 16  # same default cap as solve() — see mesh branch
        dp = self._with_b(b)
        res = solve(
            dp, method=self.method, line_search=self.line_search,
            tol=tol, max_iter=max_iter, chunk=self.chunk, dtype=self.dtype,
            x0=x0, **kw,
        )
        if refine > 0:
            from dataclasses import replace as dc_replace

            from .solvers.base import refine_polish

            prob = dc_replace(self._problem, b=np.asarray(b, np.float64))
            res = refine_polish(prob, dp, res, rounds=refine,
                                target_rel_gap=refine_tol)
        return res

    def warmup(self, num_scenarios: int = 1) -> None:
        """Compile the solve path for a given batch width before traffic."""
        shape = (self._m,) if num_scenarios == 1 else (num_scenarios, self._m)
        if self._eq:
            self.solve(np.zeros(shape, np.float32), tol=0.0, max_iter=self.chunk,
                       outer_iters=1, inner_iters=self.chunk)
        else:
            self.solve(np.zeros(shape, np.float32), tol=0.0, max_iter=self.chunk)


def _slice_result(res: SolveResult, i: int) -> SolveResult:
    """Per-request view of a batched SolveResult (scenario i)."""
    pick = lambda a: np.asarray(a)[i] if np.asarray(a).ndim >= 1 else a
    return SolveResult(
        x=np.asarray(res.x)[i],
        objective=float(np.asarray(res.objective)[i]),
        gap=float(np.asarray(res.gap)[i]),
        iterations=res.iterations,
        converged=res.converged,
        trace_f=np.asarray(res.trace_f)[i],
        trace_gap=np.asarray(res.trace_gap)[i],
        chunk_times=res.chunk_times,
        chunk_iters=res.chunk_iters,
        stop_reason=res.stop_reason,
    )


class BatchQueue:
    """Micro-batching front for an Endpoint: concurrent requests coalesce
    onto the multi-RHS scenario axis — the throughput axis of the sparse
    path (batched gathers amortise the random access over the batch) — and
    batch widths are
    rounded up to powers of two so the jit cache stays small and warm.

        q = BatchQueue(Endpoint(problem), max_batch=32, max_wait_ms=20)
        fut = q.submit(b_new)            # thread-safe, returns a Future
        res = fut.result()               # per-request SolveResult
        q.close()

    Solve options are fixed per queue (one compiled program family); all
    jax work runs on the single worker thread.  Dummy pad scenarios reuse
    the first request's b so every lane converges at the same rate.
    """

    def __init__(self, endpoint: Endpoint, max_batch: int = 32,
                 max_wait_ms: float = 20.0, tol: float = 1e-6,
                 max_iter: int = 10_000, **solve_kw):
        import queue as _queue
        import threading

        self.endpoint = endpoint
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self._solve_kw = dict(tol=tol, max_iter=max_iter, **solve_kw)
        self._q: "_queue.Queue" = _queue.Queue()
        self._stop = threading.Event()
        self.batches_run = 0
        self.requests_served = 0
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, b: np.ndarray):
        from concurrent.futures import Future

        fut: Future = Future()
        self._q.put((np.asarray(b, np.float32), fut))
        return fut

    def _run(self):
        import queue as _queue
        import time as _time

        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.05)
            except _queue.Empty:
                continue
            batch = [first]
            deadline = _time.monotonic() + self.max_wait
            while len(batch) < self.max_batch:
                left = deadline - _time.monotonic()
                if left <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=left))
                except _queue.Empty:
                    break
            bs = [b for b, _ in batch]
            # pad to the next power of two with copies of the first request:
            # one compiled program per width bucket, all lanes same shape
            S = len(bs)
            S_pad = 1 << (S - 1).bit_length()
            bs = bs + [bs[0]] * (S_pad - S)
            try:
                if S_pad == 1:
                    res = self.endpoint.solve(bs[0], **self._solve_kw)
                    results = [res]
                else:
                    res = self.endpoint.solve(np.stack(bs), **self._solve_kw)
                    results = [_slice_result(res, i) for i in range(S)]
                for (_, fut), r in zip(batch, results):
                    fut.set_result(r)
            except Exception as exc:  # propagate to every waiter
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(exc)
            self.batches_run += 1
            self.requests_served += S

    def close(self, timeout: float = 10.0):
        self._stop.set()
        self._worker.join(timeout=timeout)
