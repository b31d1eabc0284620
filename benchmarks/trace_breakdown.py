#!/usr/bin/env python
"""Where the device time goes in one solve: a profiler trace reduced to
device time per kernel and the device's busy share of the window.

    python benchmarks/trace_breakdown.py [--config medium] [--scenarios 128]
        [--iters 300] [--out chiprun_out/trace] [--top 20]

Prepares the instance, warms the chunk executable with one solve, then
traces a second solve (tol=0, fixed budget, lipschitz given) of the same
DeviceProblem.  From the trace's GPU plane: device time per kernel name,
summed over the stream lines (one event per kernel launch), and busy = the
union of the kernel intervals over the window from the first to the last
kernel.  Copies (events on a memcpy-only stream, or named Memcpy*/Memset*
on a compute stream) are counted apart, in ``copy_ms``, and are neither
kernel time nor busy time.  One JSON line per kernel name, then a summary
line.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
from collections import defaultdict

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def _union_ns(intervals) -> float:
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _is_copy(line_name: str, event_name: str) -> bool:
    # stream lines are named like "Stream #14(MemcpyH2D)" or
    # "Stream #13(MemcpyD2D,Compute)"
    if "Compute" not in line_name and "Memcpy" in line_name:
        return True
    return event_name.lower().startswith(("memcpy", "memset"))


def reduce_trace(path: str, top: int) -> dict:
    """Device time per kernel name and busy share from one .xplane.pb."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    per_kernel = defaultdict(float)
    kernels = []
    copy_ns = 0.0
    lines_seen = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            lines_seen.append(f"{plane.name}:{line.name}")
            if not line.name.startswith("Stream"):
                continue
            for e in line.events:
                if _is_copy(line.name, e.name):
                    copy_ns += e.duration_ns
                    continue
                per_kernel[e.name] += e.duration_ns
                kernels.append((e.start_ns, e.start_ns + e.duration_ns))
    if not kernels:
        raise SystemExit(f"no GPU kernel events in {path}; lines: {lines_seen}")
    t0 = min(s for s, _ in kernels)
    t1 = max(e for _, e in kernels)
    busy = _union_ns(kernels)
    total = sum(per_kernel.values()) or 1.0
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:top]
    return {
        "window_ms": (t1 - t0) / 1e6,
        "busy_ms": busy / 1e6,
        "idle_share": 1.0 - busy / max(t1 - t0, 1.0),
        "kernel_ms": total / 1e6,
        "copy_ms": copy_ns / 1e6,
        "top": [{"kernel": k, "ms": v / 1e6, "share_of_kernel_time": v / total}
                for k, v in ranked],
        "lines": lines_seen,
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="medium")
    p.add_argument("--scenarios", type=int, default=128)
    p.add_argument("--iters", type=int, default=300)
    p.add_argument("--out", default=os.path.join(HERE, "chiprun_out", "trace"))
    p.add_argument("--top", type=int, default=20)
    args = p.parse_args(argv)
    import jax

    import bsls_tpu as bsls
    from bsls_tpu.models import synthetic
    from bsls_tpu.ops import layout as L
    from bsls_tpu.solvers.base import power_lipschitz
    from bsls_tpu.utils.compile_cache import enable_compile_cache

    d = jax.devices()[0]
    if d.platform != "gpu":
        raise SystemExit(f"trace_breakdown: needs a GPU, found {d.platform}")
    enable_compile_cache()
    prob = synthetic.make_config(args.config)
    if args.scenarios > 1:
        prob = synthetic.with_scenarios(prob, args.scenarios, seed=1)
    dp = L.prepare(prob)
    lip = float(np.asarray(power_lipschitz(L.prepare(synthetic.make_config(args.config)))))
    kw = dict(method="pgd", line_search="exact", tol=0.0, max_iter=args.iters,
              chunk=100, lipschitz=lip)
    bsls.solve(dp, **kw)  # compile + warm
    t = time.perf_counter()
    with jax.profiler.trace(args.out):
        res = bsls.solve(dp, **kw)
    wall = time.perf_counter() - t
    path = sorted(glob.glob(os.path.join(args.out, "**", "*.xplane.pb"),
                            recursive=True), key=os.path.getmtime)[-1]
    out = reduce_trace(path, args.top)
    for row in out.pop("top"):
        print(json.dumps(row), flush=True)
    print(json.dumps({"config": args.config, "scenarios": args.scenarios,
                      "iters": args.iters, "wall_s": wall,
                      "agg_iters_per_sec_traced": args.scenarios * args.iters / wall,
                      "device_kind": d.device_kind,
                      "objective_max": float(np.max(res.objective)), **out}),
          flush=True)


if __name__ == "__main__":
    main()
