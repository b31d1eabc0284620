"""Benchmark: one JSON line {"metric","value","unit","vs_baseline","device"}.

Measures steady-state projected-gradient iterations/sec on the medium
benchmark config (10k blocks, sparse A ~100k x 55k — BASELINE.json:8) at a
batch of SCENARIOS right-hand sides on the first JAX device, against the
*measured* single-threaded C baseline (benchmarks/baseline_c) on the same
host — no published reference numbers exist.  Runs in one process; the C
baseline runs as a child that uses no JAX.

The instance and the C baseline result are cached in .bench/ so repeat
runs are fast; delete .bench/ to re-measure.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
CACHE = os.path.join(HERE, ".bench")

SEED = 0
C_ITERS = 60
WARM_CHUNKS = 1
CHUNK = 100
CHUNKS = 5
# multi-RHS batch width (BASELINE.json:10): the gathers of A amortise over
# the batch.  Kept from the first benchmark; the optimum on the current
# device has not been re-swept.
SCENARIOS = 128


def get_problem():
    from bsls_tpu.models import synthetic

    path = os.path.join(CACHE, "medium.npz")
    if os.path.exists(path):
        from bsls_tpu.models import Problem

        return Problem.load(path)
    prob = synthetic.medium_sparse(seed=SEED)
    os.makedirs(CACHE, exist_ok=True)
    prob.save_npz(path)
    return prob


def c_baseline(prob) -> dict:
    path = os.path.join(CACHE, "c_baseline.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "baseline_runner", os.path.join(HERE, "benchmarks", "baseline_c", "runner.py")
    )
    runner = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(runner)
    res = runner.run_baseline(prob, iters=C_ITERS)
    os.makedirs(CACHE, exist_ok=True)
    with open(path, "w") as f:
        json.dump(res, f)
    return res


def device_run(prob, scenarios: int) -> dict:
    import bsls_tpu as bsls
    from bsls_tpu.models.synthetic import with_scenarios

    if scenarios > 1:
        prob = with_scenarios(prob, scenarios, seed=SEED + 1)
    res = bsls.solve(
        prob, method="pgd", line_search="exact", tol=0.0,
        max_iter=CHUNK * (WARM_CHUNKS + CHUNKS), chunk=CHUNK,
    )
    # steady state: iterations-spanned / seconds-spanned, skipping the
    # first sync interval (async loop: one chunk_times entry may cover
    # several chunks)
    return {
        "iters_per_sec": scenarios * res.steady_iters_per_sec(),
        "objective": float(np.max(np.asarray(res.objective))),
    }


def device_info() -> dict:
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def main():
    from bsls_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    prob = get_problem()
    c = c_baseline(prob)
    # aggregate solver iterations/sec across the scenario batch: the C
    # baseline (like the reference) solves scenarios sequentially at
    # c["iters_per_sec"] each, so the ratio is aggregate device rate / C rate.
    t = device_run(prob, SCENARIOS)
    print(json.dumps({
        "metric": f"pgd_aggregate_iters_per_sec_medium_x{SCENARIOS}",
        "value": round(t["iters_per_sec"], 3),
        "unit": "iter/s",
        "vs_baseline": round(t["iters_per_sec"] / c["iters_per_sec"], 3),
        "device": device_info(),
    }))
    # extra context on stderr (not part of the result line)
    print(
        f"# c_baseline={c['iters_per_sec']:.1f} iter/s scenarios={SCENARIOS} "
        f"objective_max={t['objective']:.6e} c_objective={c['objective']:.6e} "
        f"(objectives are not comparable: the C side is budget-limited to "
        f"{C_ITERS} iterations to measure its rate, the device side runs "
        f"{CHUNK * (WARM_CHUNKS + CHUNKS)})",
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
