#!/usr/bin/env python
"""Main-path check on NVIDIA GPUs, through the public entry points.

    python chip_smoke.py           # one card, phases 1-6 below
    python chip_smoke.py --multi   # four cards: the mesh path only

One card (one JAX process, phases in order; any failure raises and the
exit code is nonzero):
  1. kernels and precision: the block-simplex projection as dispatched on
     the card vs the float64 numpy reference at three width profiles
     (medium x128, width 12 padded to 16, config 4), and the dense
     matvec / rmatvec vs numpy float64 (no TF32);
  2. solve(medium x128, pgd/exact, 600 iterations): finite objectives; two
     scenarios re-solved on the CPU backend in this process agree to 1e-3;
  3. solve(medium, lbfgs, tol=1e-6, refine_tol=1e-6): float64 certificate
     <= 1e-6 and objective within 2e-6 of the float64 oracle;
  4. medium_banded at S=4, layout banded vs gather: objectives agree to 1e-4;
  5. Endpoint(traffic) answers 3 perturbed requests, each ||Cx-d||_inf <= 1e-6;
  6. config 4 (1M blocks x 8, 4 scenarios) on one card, 200 iterations.

--multi (four cards): __graft_entry__.dryrun_multichip(4), then config 4
through solve_sharded on make_mesh(block=4) and make_mesh(block=2,
scenario=2), each against the unsharded one-card solve (same lipschitz,
tol=0, 200 iterations): in float32 the objective traces agree to rtol 1e-4
wherever float32 resolves that, and in float64 the objectives of the
returned iterates agree to rtol 1e-4.

The last line of stdout is {"ok": true, "device": {...}}; it is printed
only when every phase passed.  With no GPU the script exits nonzero before
any phase.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# f* of medium (seed 0) from models.oracle.oracle_solve (float64 FISTA,
# 100k iterations; minutes on a host, so it is recorded), with a fingerprint
# of the instance it was computed on; another instance (another numpy
# stream) recomputes it.
MEDIUM_ORACLE = os.path.join(HERE, "benchmarks", "oracle_medium_seed0.json")


def require_gpu():
    """The first JAX device must be a GPU; anything else ends the run."""
    import jax

    try:
        devices = jax.devices()
    except RuntimeError as e:  # no backend at all
        raise SystemExit(f"chip_smoke: JAX found no accelerator ({e})")
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU; JAX's first device is {devices[0].platform}")
    return devices


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True)
    return out.stdout.strip()


def phase(name):
    def deco(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            print(f"[{name}] start", flush=True)
            out = fn(*a, **kw)
            print(f"[{name}] PASS {time.perf_counter() - t0:.1f}s", flush=True)
            return out
        return run
    return deco


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------- phase 1

def _proj_check(label, v, widths, radius, sample=4000, seed=0):
    """v (S, B, w) on the device; projected through the production
    dispatch under a scenario vmap; checked on all block sums and, on a
    sample of rows, elementwise against the float64 reference."""
    import jax
    import jax.numpy as jnp

    from bsls_tpu.ops.layout import DeviceBucket
    from bsls_tpu.ops.projection import proj_blocks
    from bsls_tpu.utils.refimpl import proj_simplex_np

    w = v.shape[-1]
    mask = (jnp.arange(w) < widths[:, None]).astype(v.dtype)
    bk = DeviceBucket(mask=mask, sizes=widths, radius=radius, width=w)
    f = jax.jit(jax.vmap(lambda x: proj_blocks((x,), (bk,))[0]))
    out = np.asarray(f(v), np.float64)
    vh = np.asarray(v, np.float64)
    wh = np.asarray(widths)
    rh = np.asarray(radius, np.float64)
    real = wh > 0
    sums = out.sum(-1)[:, real]
    sum_err = float(np.max(np.abs(sums - rh[real]) / rh[real]))
    check(sum_err <= 1e-5, f"{label}: block sums off by {sum_err:.3e} rel")
    check(np.all(out >= 0), f"{label}: negative entries")
    check(np.all(out[..., ~real, :] == 0), f"{label}: dummy rows not zero")
    rng = np.random.default_rng(seed)
    S, B = vh.shape[:2]
    worst = 0.0
    for s, i in zip(rng.integers(0, S, sample), rng.integers(0, B, sample)):
        n = int(wh[i])
        if n == 0:
            continue
        ref = rh[i] * proj_simplex_np(vh[s, i, :n] / rh[i])
        err = np.abs(out[s, i, :n] - ref) - (1e-5 * rh[i] + 1e-6)
        worst = max(worst, float(err.max()))
        check(np.all(out[s, i, n:] == 0), f"{label}: padding slot not zero")
    check(worst <= 0.0, f"{label}: |x - x_ref| exceeds 1e-5*radius + 1e-6 "
          f"by {worst:.3e}")
    print(f"  projection {label}: shape {tuple(v.shape)} block-sum rel err "
          f"{sum_err:.2e}, sampled rows within tolerance", flush=True)


@phase("1 kernels+precision")
def phase_kernels(medium, S=128, B12=4096, B_large=1_000_000):
    import jax
    import jax.numpy as jnp

    from bsls_tpu.models import synthetic
    from bsls_tpu.ops import layout as L

    key = jax.random.key(0)
    # (a) medium x128: the instance's own buckets and equilibrated radii
    dp = L.prepare(medium)
    for j, bk in enumerate(dp.buckets):
        v = 3.0 * jax.random.normal(jax.random.fold_in(key, j),
                                    (S,) + bk.mask.shape, jnp.float32)
        _proj_check(f"medium x{S} bucket {j} (w={bk.mask.shape[1]})", v,
                    bk.sizes, bk.radius)
    # (b) widths 2-12, padded to 16 (the widest the kernel takes), 128 x
    # 4096 blocks
    k1, k2, k3 = jax.random.split(jax.random.fold_in(key, 99), 3)
    _proj_check(f"w=12 x{S}", 3.0 * jax.random.normal(k1, (S, B12, 12)),
                jax.random.randint(k2, (B12,), 2, 13),
                jax.random.uniform(k3, (B12,), minval=0.5, maxval=2.0))
    # (c) config 4: 1M blocks x 8, 4 scenarios
    k1, k2 = jax.random.split(jax.random.fold_in(key, 7))
    _proj_check(f"config-4 {B_large} x 8 x4",
                3.0 * jax.random.normal(k1, (4, B_large, 8)),
                jnp.full((B_large,), 8, jnp.int32),
                jax.random.uniform(k2, (B_large,), minval=0.5, maxval=2.0))
    # dense matvec / rmatvec at HIGHEST precision vs numpy float64
    tiny = synthetic.make_config("tiny")
    dt = L.prepare(tiny)
    A64 = np.asarray(dt.A.data, np.float64)
    # float32 inputs, float64 reference on exactly those values
    X = np.abs(np.random.default_rng(1).standard_normal(
        (16, A64.shape[1]))).astype(np.float32).astype(np.float64)
    R = np.random.default_rng(2).standard_normal(
        (16, A64.shape[0])).astype(np.float32).astype(np.float64)
    for name, fn, arg, ref in (
        ("matvec", L.matvec, X, X @ A64.T),
        ("rmatvec", L.rmatvec, R, R @ A64),
    ):
        single = np.asarray(jax.jit(lambda v: fn(dt.A, v))(
            jnp.asarray(arg[0], jnp.float32)), np.float64)
        batch = np.asarray(jax.jit(jax.vmap(lambda v: fn(dt.A, v)))(
            jnp.asarray(arg, jnp.float32)), np.float64)
        for what, got, want in (("single", single, ref[0]), ("x16", batch, ref)):
            rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
            print(f"  dense {name} {what}: rel err {rel:.2e}", flush=True)
            check(rel <= 1e-6, f"dense {name} {what}: rel err {rel:.3e} > 1e-6")


# ---------------------------------------------------------------- phase 2

@phase("2 solve medium x128 pgd/exact")
def phase_medium_batch(medium, S=128):
    import jax

    import bsls_tpu as bsls
    from bsls_tpu.models.synthetic import with_scenarios
    from bsls_tpu.ops import layout as L
    from bsls_tpu.solvers.base import power_lipschitz

    prob = with_scenarios(medium, S, seed=1)
    lip = float(np.asarray(power_lipschitz(L.prepare(medium))))
    kw = dict(method="pgd", line_search="exact", tol=0.0, max_iter=600,
              chunk=100, lipschitz=lip)
    res = bsls.solve(prob, **kw)
    obj = np.asarray(res.objective)
    check(obj.shape == (S,) and np.all(np.isfinite(obj)),
          f"medium x{S}: non-finite objectives")
    print(f"  medium x{S}: aggregate {S * res.steady_iters_per_sec():.1f} "
          f"it/s, objective max {obj.max():.6e}", flush=True)
    two = type(prob)(A=prob.A, b=prob.b[:2], partition=prob.partition,
                     name=prob.name + "[:2]")
    with jax.default_device(jax.devices("cpu")[0]):
        res_cpu = bsls.solve(two, **kw)
    ocpu = np.asarray(res_cpu.objective)
    rel = np.abs(obj[:2] - ocpu) / np.maximum(1.0, np.abs(ocpu))
    print(f"  gpu vs cpu (2 scenarios): {obj[:2]} vs {ocpu}, rel {rel}",
          flush=True)
    check(np.all(rel <= 1e-3), f"gpu/cpu objective mismatch: rel {rel}")


# ---------------------------------------------------------------- phase 3

def _fingerprint(prob) -> list:
    b = np.asarray(prob.b, np.float64)
    return [float(b.sum()), float(np.abs(b).sum()), int(prob.partition.n_flat)]


def medium_oracle(medium) -> float:
    with open(MEDIUM_ORACLE) as fh:
        rec = json.load(fh)
    if np.allclose(rec["fingerprint"], _fingerprint(medium), rtol=1e-12):
        return float(rec["objective"])
    print("  oracle record is for another instance; recomputing", flush=True)
    from bsls_tpu.models import oracle_solve

    return float(oracle_solve(medium).objective)


@phase("3 solve medium lbfgs certified")
def phase_lbfgs(medium, f_star):
    import bsls_tpu as bsls

    res = bsls.solve(medium, method="lbfgs", tol=1e-6, refine_tol=1e-6)
    f = float(np.asarray(res.objective))
    rel = (f - f_star) / max(1.0, abs(f_star))
    print(f"  lbfgs: {res.iterations} it, f={f:.10e} f*={f_star:.10e} "
          f"rel {rel:.2e}, certificate {res.refine_fw_gap:.2e}", flush=True)
    check(res.refine_fw_gap is not None and res.refine_fw_gap <= 1e-6,
          f"certificate {res.refine_fw_gap} > 1e-6")
    check(abs(rel) <= 2e-6, f"objective {rel:.3e} rel from the oracle")


# ---------------------------------------------------------------- phase 4

@phase("4 medium_banded S=4 banded vs gather")
def phase_banded(banded):
    import bsls_tpu as bsls
    from bsls_tpu.models import synthetic
    from bsls_tpu.ops import layout as L
    from bsls_tpu.ops.banded import DeviceBanded
    from bsls_tpu.solvers.base import power_lipschitz

    prob = synthetic.with_scenarios(banded, 4)
    lip = float(np.asarray(power_lipschitz(L.prepare(prob, layout="gather"))))
    objs = {}
    for layout in ("banded", "gather"):
        dp = L.prepare(prob, layout=layout)
        check(isinstance(dp.A, DeviceBanded) == (layout == "banded"),
              f"layout={layout} not honoured")
        res = bsls.solve(dp, method="pgd", line_search="exact", tol=0.0,
                         max_iter=300, chunk=100, lipschitz=lip)
        objs[layout] = np.asarray(res.objective)
        check(np.all(np.isfinite(objs[layout])), f"{layout}: non-finite")
        print(f"  {layout}: {4 * res.steady_iters_per_sec():.1f} agg it/s, "
              f"objectives {objs[layout]}", flush=True)
    rel = np.abs(objs["banded"] - objs["gather"]) / np.maximum(
        1.0, np.abs(objs["gather"]))
    check(np.all(rel <= 1e-4), f"banded vs gather rel {rel}")


# ---------------------------------------------------------------- phase 5

@phase("5 Endpoint(traffic)")
def phase_endpoint(prob):
    from bsls_tpu.serving import Endpoint

    ep = Endpoint(prob)
    rng = np.random.default_rng(1)
    b0 = np.asarray(prob.b)
    for i in range(3):
        b = (b0 * (1.0 + 0.02 * rng.standard_normal(b0.shape))).astype(np.float32)
        t0 = time.perf_counter()
        res = ep.solve(b, tol=1e-6)
        viol = float(res.eq_violation)
        print(f"  request {i}: {time.perf_counter() - t0:.2f}s eq_violation "
              f"{viol:.2e} objective {float(np.asarray(res.objective)):.6e}",
              flush=True)
        check(np.isfinite(float(np.asarray(res.objective))),
              f"request {i}: non-finite objective")
        check(viol <= 1e-6, f"request {i}: eq_violation {viol:.3e} > 1e-6")


# ---------------------------------------------------------------- phase 6

@phase("6 config 4 on one card")
def phase_large(prob):
    import jax

    import bsls_tpu as bsls

    res = bsls.solve(prob, method="pgd", line_search="exact", tol=0.0,
                     max_iter=200, chunk=50)
    obj = np.asarray(res.objective)
    check(np.all(np.isfinite(obj)), "config 4: non-finite objectives")
    stats = jax.devices()[0].memory_stats() or {}
    print(f"  config 4: {4 * res.steady_iters_per_sec():.2f} agg it/s, "
          f"objectives {obj}, peak_bytes_in_use "
          f"{stats.get('peak_bytes_in_use')}", flush=True)


# ---------------------------------------------------------------- --multi

# Mesh vs one card, relative tolerance on the objective.
RTOL_MESH = 1e-4


def _f32_resolved_floor(prob) -> np.ndarray:
    """(S,) smallest objective float32 resolves to RTOL_MESH.  r = Ax - b is
    formed from terms the size of b, so float32 carries r to about
    eps32 * ||b|| and f = 0.5 ||r||^2 to about eps32 * ||b|| * ||r||; that
    is within RTOL_MESH of f once f >= 0.5 (eps32 ||b|| / RTOL_MESH)^2."""
    b_norm = np.linalg.norm(np.asarray(prob.b, np.float64), axis=-1)
    return 0.5 * (np.finfo(np.float32).eps * b_norm / RTOL_MESH) ** 2


def _large_mesh_checks(num_blocks: int, m: int = 262_144):
    """Config 4 through solve_sharded on two meshes vs the one-card solve
    (same lipschitz, tol=0, 200 iterations of pgd/exact).

    float32 (the production dtype): the per-iteration objectives agree to
    RTOL_MESH at every iteration whose objective float32 resolves to that
    tolerance.  Config 4 is underdetermined (8M unknowns, 262,144 rows), so
    the objective falls towards 0 and, within the 200 iterations, below
    what float32 resolves; there both paths sit at float32's floor and
    differ by rounding.  float64: the whole run is resolved, and the
    float64 objectives of the returned iterates agree to RTOL_MESH."""
    import jax
    import jax.numpy as jnp

    from bsls_tpu.models import synthetic
    from bsls_tpu.ops import layout as L
    from bsls_tpu.parallel import make_mesh, solve_sharded
    from bsls_tpu.solvers.base import power_lipschitz, solve

    devices = jax.devices()[:4]
    t0 = time.perf_counter()
    prob = synthetic.make_config("large", num_blocks=num_blocks, m=m)
    print(f"  generated {prob.A.shape} in {time.perf_counter() - t0:.1f}s",
          flush=True)
    lip = float(np.asarray(power_lipschitz(L.prepare(prob))))
    kw = dict(method="pgd", line_search="exact", tol=0.0, max_iter=200,
              chunk=50, lipschitz=lip)
    meshes = [make_mesh(devices=devices, **shape)
              for shape in (dict(block=4), dict(block=2, scenario=2))]

    one = solve(prob, **kw)
    f_one = np.asarray(one.trace_f, np.float64)  # (S, iterations)
    resolved = f_one >= _f32_resolved_floor(prob)[:, None]
    check(resolved[:, 0].all(), "float32 resolves no iteration of the run")
    print(f"  float32 one card: objectives {np.asarray(one.objective)}, "
          f"float64 objective of x {prob.objective_np(one.x)}, iterations "
          f"resolved to {RTOL_MESH:g}: {resolved.sum(axis=1)}", flush=True)
    for mesh in meshes:
        res = solve_sharded(prob, mesh, **kw)
        f_mesh = np.asarray(res.trace_f, np.float64)
        check(f_mesh.shape == f_one.shape and np.all(np.isfinite(f_mesh)),
              f"mesh {dict(mesh.shape)}: trace {f_mesh.shape}, non-finite?")
        rel = np.abs(f_mesh - f_one) / f_one
        worst = float(rel[resolved].max())
        print(f"  float32 mesh {dict(mesh.shape)}: objectives "
              f"{np.asarray(res.objective)}, float64 objective of x "
              f"{prob.objective_np(res.x)}, resolved iterations max rel "
              f"{worst:.2e}, {4 * res.steady_iters_per_sec():.2f} agg it/s",
              flush=True)
        check(worst <= RTOL_MESH, f"mesh {dict(mesh.shape)} vs one card: "
              f"rel {worst:.3e} on resolved iterations")
        for d in devices:
            peak = (d.memory_stats() or {}).get("peak_bytes_in_use", 0)
            print(f"    {d}: peak_bytes_in_use {peak}", flush=True)
            check(d.platform != "gpu" or peak > 0, f"{d} held no shard")

    with jax.enable_x64(True):
        ref = prob.objective_np(solve(prob, dtype=jnp.float64, **kw).x)
        print(f"  float64 one card: objective of x {ref}", flush=True)
        for mesh in meshes:
            got = prob.objective_np(
                solve_sharded(prob, mesh, dtype=jnp.float64, **kw).x)
            rel = np.abs(got - ref) / np.abs(ref)
            print(f"  float64 mesh {dict(mesh.shape)}: objective of x {got}, "
                  f"rel {rel}", flush=True)
            check(np.allclose(got, ref, rtol=RTOL_MESH, atol=0.0),
                  f"float64 mesh {dict(mesh.shape)} vs one card: rel {rel}")


def run_multi(num_blocks: int):
    import __graft_entry__

    phase("M1 dryrun_multichip(4)")(__graft_entry__.dryrun_multichip)(4)
    phase("M2 config 4 sharded vs one card")(_large_mesh_checks)(num_blocks)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--multi", action="store_true",
                   help="run only the four-card mesh checks")
    args = p.parse_args(argv)
    require_gpu()
    from bsls_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    print(card_line(), flush=True)
    run(args.multi)


def run(multi: bool, large_blocks: int = 1_000_000):
    """All phases at full size, then the result line."""
    import jax

    from bsls_tpu.models import synthetic

    print(f"jax {jax.__version__}; devices {jax.devices()}; device_kind "
          f"{jax.devices()[0].device_kind}", flush=True)
    t0 = time.perf_counter()
    if multi:
        check(len(jax.devices()) == 4, "--multi needs exactly four devices")
        run_multi(large_blocks)
    else:
        medium = synthetic.make_config("medium")
        phase_kernels(medium)
        phase_medium_batch(medium)
        phase_lbfgs(medium, medium_oracle(medium))
        phase_banded(synthetic.make_config("medium_banded"))
        phase_endpoint(synthetic.make_config("traffic"))
        t1 = time.perf_counter()
        large = synthetic.make_config("large", num_blocks=large_blocks)
        print(f"config 4 generated {large.A.shape} in "
              f"{time.perf_counter() - t1:.1f}s", flush=True)
        phase_large(large)
    print(f"all phases passed in {time.perf_counter() - t0:.1f}s", flush=True)
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
