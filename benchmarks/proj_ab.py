#!/usr/bin/env python
"""Projection path A/B on one GPU: the Triton kernel vs XLA's sort path.

    python benchmarks/proj_ab.py [--reps 50] [--e2e]

Isolated: host wall time per call of the bucket projection as the solvers
dispatch it (under a scenario vmap), at three width profiles: medium x128
(the instance's own buckets, padded widths 4 and 8), width 12 x128 x 4096
blocks (padded width 16, the widest the kernel takes), and config 4 (1M
blocks x 8, 4 scenarios).  Paths: "xla" (proj_simplex_padded) and
"kernel" (the Triton kernel as dispatched).  The time is the wall of
``reps`` back-to-back asynchronous calls over ``reps``: with the queue
kept full it approaches the device time per call but includes any launch
gaps.  Each measurement also traces ``reps`` calls and reports the device
time per call from the trace (kernels only, benchmarks/trace_breakdown.py).

--e2e: bench.py's measurement (medium x128, pgd/exact, aggregate it/s)
with each path, in the order xla, kernel, kernel, xla, so that drift
over the run shows.  One JSON line per measurement on stdout.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "benchmarks"))


def set_path(path: str):
    """Route ops.projection.proj_blocks through one projection path and
    drop every compiled executable that may hold the previous one."""
    import jax

    import bsls_tpu.ops.projection as P
    from bsls_tpu.solvers import base

    if not hasattr(P, "_orig_bucket"):
        P._orig_bucket = P._proj_bucket
    if path == "xla":
        P._proj_bucket = lambda x, bk: P.proj_simplex_padded(x, bk.mask, bk.radius)
    else:
        P._proj_bucket = P._orig_bucket
    base._AOT_CACHE.clear()
    jax.clear_caches()


def _time_call(f, x, reps: int) -> float:
    import jax

    jax.block_until_ready(f(x))  # compile + warm
    samples = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = f(x)
        jax.block_until_ready(out)
        samples.append((time.perf_counter() - t0) / reps)
    return float(np.median(samples))


def _device_us_per_call(f, x, reps: int, out_dir: str) -> float:
    """Kernel time per call from a profiler trace of ``reps`` calls (the
    trace is removed once read)."""
    import glob
    import shutil

    import jax

    from trace_breakdown import reduce_trace

    jax.block_until_ready(f(x))
    with jax.profiler.trace(out_dir):
        for _ in range(reps):
            out = f(x)
        jax.block_until_ready(out)
    path = sorted(glob.glob(os.path.join(out_dir, "**", "*.xplane.pb"),
                            recursive=True), key=os.path.getmtime)[-1]
    kernel_ms = reduce_trace(path, top=1)["kernel_ms"]
    shutil.rmtree(out_dir, ignore_errors=True)
    return kernel_ms * 1e3 / reps


def profiles():
    import jax
    import jax.numpy as jnp

    from bsls_tpu.models import synthetic
    from bsls_tpu.ops import layout as L
    from bsls_tpu.ops.layout import DeviceBucket

    key = jax.random.key(0)
    dp = L.prepare(synthetic.make_config("medium"))
    xs = tuple(jax.random.normal(jax.random.fold_in(key, j),
                                 (128,) + bk.mask.shape, jnp.float32)
               for j, bk in enumerate(dp.buckets))
    yield "medium x128", xs, dp.buckets

    def bucket(widths, radius, w):
        mask = (jnp.arange(w) < widths[:, None]).astype(jnp.float32)
        return DeviceBucket(mask=mask, sizes=widths, radius=radius, width=w)

    k1, k2, k3 = jax.random.split(jax.random.fold_in(key, 99), 3)
    B = 4096
    yield "w12 x128 x4096", (jax.random.normal(k1, (128, B, 12)),), (bucket(
        jax.random.randint(k2, (B,), 2, 13),
        jax.random.uniform(k3, (B,), minval=0.5, maxval=2.0), 12),)
    k1, k2 = jax.random.split(jax.random.fold_in(key, 7))
    B = 1_000_000
    yield "config4 1M x8 x4", (jax.random.normal(k1, (4, B, 8)),), (bucket(
        jnp.full((B,), 8, jnp.int32),
        jax.random.uniform(k2, (B,), minval=0.5, maxval=2.0), 8),)


def isolated(reps: int, trace_dir: str):
    import jax

    from bsls_tpu.ops import projection as P

    for label, xs, buckets in profiles():
        slots = sum(int(np.prod(x.shape)) for x in xs)
        for path in ("xla", "kernel") * 2:
            set_path(path)
            f = jax.jit(jax.vmap(lambda p, bks=buckets: P.proj_blocks(p, bks)))
            t = _time_call(f, xs, reps)
            dev = _device_us_per_call(f, xs, reps, os.path.join(
                trace_dir, f"{label.split()[0]}_{path}"))
            print(json.dumps({"kind": "isolated", "profile": label, "path": path,
                              "slots": slots, "host_wall_us_per_call": t * 1e6,
                              "device_us_per_call": dev}), flush=True)


def end_to_end():
    import bench

    prob = bench.get_problem()
    for path in ("xla", "kernel", "kernel", "xla"):
        set_path(path)
        t0 = time.perf_counter()
        r = bench.device_run(prob, bench.SCENARIOS)
        print(json.dumps({"kind": "e2e", "path": path,
                          "agg_iters_per_sec": r["iters_per_sec"],
                          "objective_max": r["objective"],
                          "wall_s": time.perf_counter() - t0}), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--reps", type=int, default=50)
    p.add_argument("--e2e", action="store_true")
    p.add_argument("--trace-dir", default=os.path.join(HERE, "chiprun_out",
                                                       "proj_ab_trace"))
    args = p.parse_args(argv)
    import jax

    from bsls_tpu.utils.compile_cache import enable_compile_cache

    d = jax.devices()[0]
    if d.platform != "gpu":
        raise SystemExit(f"proj_ab: needs a GPU, found {d.platform}")
    enable_compile_cache()
    print(json.dumps({"kind": "device", "kind_name": d.device_kind,
                      "count": len(jax.devices())}), flush=True)
    isolated(args.reps, args.trace_dir)
    if args.e2e:
        end_to_end()


if __name__ == "__main__":
    main()
