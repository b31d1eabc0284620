"""Solve/benchmark CLI (installed surface).

    python -m bsls_tpu --preset medium-pgd
    bsls --config tiny --method lbfgs --tol 1e-8
    bsls --config medium --mesh-block 8 --platform cpu8
    bsls --config traffic --oracle --metrics out.jsonl
    bsls --config instance.npz --method apgd        # or .mat (v5-v7.3)

Emits one JSON result line: iterations/s, time-to-1e-6-relative-gap (when
--oracle supplies f*), objective-vs-oracle, device info.  This is the L4
driver of SURVEY.md §2 #16 (benchmarks/run.py is a thin shim over it).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--preset", default=None, help="named preset from utils.config")
    p.add_argument("--config", default=None, help="tiny|medium|traffic|large|path.npz")
    p.add_argument("--method", default=None)
    p.add_argument("--line-search", dest="line_search", default=None)
    p.add_argument("--unroll", type=int, default=None)
    p.add_argument("--tol", type=float, default=None)
    p.add_argument("--max-iter", dest="max_iter", type=int, default=None)
    p.add_argument("--chunk", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument(
        "--refine", type=int, default=None,
        help="post-solve f64-anchored polish rounds (breaks the fp32 ~1e-5 "
        "true-gap floor; unsharded unconstrained solves only)",
    )
    p.add_argument(
        "--refine-tol", dest="refine_tol", type=float, default=None,
        help="certified adaptive refine: polish until the float64 FW "
        "duality gap certifies this relative gap (--refine caps rounds); "
        "the certificate is reported as refine_fw_gap",
    )
    p.add_argument("--mesh-block", dest="mesh_block", type=int, default=None)
    p.add_argument("--mesh-scenario", dest="mesh_scenario", type=int, default=None)
    p.add_argument("--oracle", action="store_true", default=None)
    p.add_argument("--profile-dir", dest="profile_dir", default=None)
    p.add_argument("--metrics", dest="metrics_path", default=None)
    p.add_argument("--checkpoint", dest="checkpoint_path", default=None)
    p.add_argument("--checkpoint-every", dest="checkpoint_every", type=int, default=None)
    p.add_argument("--resume", action="store_true", default=None)
    p.add_argument(
        "--platform", default=None,
        help="cpu | cpu8 (8 virtual devices) | cuda (default: JAX's choice)",
    )
    p.add_argument("--debug", action="store_true",
                   help="enable jax_debug_nans (fail fast on NaN/Inf)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.platform:
        if args.platform == "cpu8":
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
            ).strip()
            os.environ["JAX_PLATFORMS"] = "cpu"
        else:
            os.environ["JAX_PLATFORMS"] = args.platform
    import jax

    if args.platform:
        # jax may already be imported (package __init__) with the env var
        # captured — config.update applies post-import for EVERY platform,
        # not just cpu (a bare env set would silently no-op here)
        jax.config.update("jax_platforms",
                          "cpu" if args.platform == "cpu8" else args.platform)
    if args.debug:
        jax.config.update("jax_debug_nans", True)

    from bsls_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()  # warm repeat runs replay compiles from disk

    import bsls_tpu as bsls
    from bsls_tpu.models import Problem, oracle_solve, synthetic
    from bsls_tpu.utils.config import load_config
    from bsls_tpu.utils.metrics import MetricsWriter
    from bsls_tpu.utils.profiling import trace

    overrides = {
        k: getattr(args, k)
        for k in (
            "config method line_search tol max_iter chunk unroll seed refine refine_tol oracle "
            "profile_dir metrics_path checkpoint_path checkpoint_every resume "
            "mesh_block mesh_scenario"
        ).split()
        if getattr(args, k) is not None
    }
    cfg = load_config(args.preset or args.config or "tiny", **overrides)

    # instance
    t_gen = time.perf_counter()
    from bsls_tpu.models.synthetic import _CONFIGS

    if cfg.config in _CONFIGS:
        prob = synthetic.make_config(cfg.config, seed=cfg.seed, **cfg.instance_kwargs)
    else:
        prob = Problem.load(cfg.config)
    t_gen = time.perf_counter() - t_gen

    f_star = None
    if cfg.oracle:
        from bsls_tpu.models.oracle import cached_oracle_objective

        # cache per (config, seed): the float64 oracle on large instances
        # costs minutes and is deterministic; ad-hoc file paths skip the cache
        key = f"{cfg.config}_{cfg.seed}" if cfg.config in _CONFIGS else None
        f_star = cached_oracle_objective(prob, key)

    mesh = None
    if cfg.mesh_block:
        from bsls_tpu.parallel import make_mesh

        mesh = make_mesh(block=cfg.mesh_block, scenario=cfg.mesh_scenario)

    with MetricsWriter(cfg.metrics_path) as mw:
        mw.log("config", **json.loads(cfg.to_json()))
        with trace(cfg.profile_dir):
            res = bsls.solve(
                prob,
                method=cfg.method,
                line_search=cfg.line_search,
                tol=cfg.tol,
                max_iter=cfg.max_iter,
                chunk=cfg.chunk,
                unroll=cfg.unroll,
                step_size=cfg.step_size,
                mesh=mesh,
                # pass the writer only when the user asked for metrics (a
                # disabled default writer must not trip the eq path's
                # unsupported-option rejection) — an EXPLICIT --metrics on an
                # eq instance flows through and errors loudly
                metrics=(mw if mesh is None and cfg.metrics_path else None),
                checkpoint_path=cfg.checkpoint_path if mesh is None else None,
                checkpoint_every=cfg.checkpoint_every or 0,
                resume=bool(cfg.resume),
                refine=cfg.refine,
                refine_tol=cfg.refine_tol,
            )

        ips = res.steady_iters_per_sec()
        out = {
            "config": cfg.config,
            "method": cfg.method,
            "line_search": cfg.line_search,
            "device": str(jax.devices()[0]),
            "n_devices": len(jax.devices()),
            "mesh": None if mesh is None else dict(mesh.shape),
            "iterations": int(res.iterations),
            "converged": bool(res.converged),
            "objective": np.asarray(res.objective).tolist(),
            "fw_gap": np.asarray(res.gap).tolist(),
            "iters_per_sec": round(ips, 3),
            "gen_secs": round(t_gen, 3),
        }
        if res.eq_violation is not None:
            out["eq_violation"] = res.eq_violation
        if cfg.refine:
            out["refine_secs"] = round(res.refine_secs, 3)
        if res.refine_fw_gap is not None:
            out["refine_fw_gap"] = res.refine_fw_gap
        if f_star is not None:
            out["oracle_objective"] = f_star
            f = float(np.max(np.asarray(res.objective)))
            out["rel_gap_vs_oracle"] = (f - f_star) / max(1.0, abs(f_star))
            t6 = res.time_to_gap(f_star, rel=1e-6)
            out["time_to_1e-6_gap_s"] = None if t6 is None else round(t6, 4)
        mw.log("result", **out)
    print(json.dumps(out))
    return out


def script_main() -> None:
    """Console-script entry: a truthy return from main() would become
    SystemExit(dict) (repr printed, nonzero exit) under setuptools."""
    main()


if __name__ == "__main__":
    main()
