#!/usr/bin/env python
"""Scaling-efficiency measurement: iterations/s vs mesh size.

    python benchmarks/scaling.py --config medium --scenarios 8 \
        --blocks 1 2 4 8 --platform cpu8

On N real devices this produces the scaling numbers of BASELINE.json:5
(efficiency vs linear); on a CPU-only host it is validated on the simulated
CPU mesh.  Efficiency_n = (ips_n / ips_1) / n.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def analyze(config: str, blocks):
    """Analytic per-iteration communication/compute model for the block-
    sharded step (the quantity that determines multi-device scaling,
    since the simulated CPU mesh shares one socket and cannot measure
    wall-clock efficiency).  Per iteration each device:

      * gathers its shard's nonzeros (the dominant cost) — divides by the
        shard count;
      * psums the length-m residual partial over the block axis (the ONE
        vector collective, 4m bytes in fp32) + 3 scalar psums (line-search
        numerator/denominator, FW gap) — constant in the shard count.

    Scaling efficiency is therefore
        eff(n) ~ t_gather(1) / (t_gather(1)/n + t_psum(n)).
    Modeled with H100 SXM datasheet rates (not measured): each random
    gather moves one 32-byte sector at 3.35 TB/s of HBM, and the psum
    rides NVLink at 450 GB/s each way.
    """
    from bsls_tpu.models import synthetic
    from bsls_tpu.models.problem import EllMatrix

    prob = synthetic.make_config(config)
    m, n = prob.A.shape
    nnz = prob.A.nnz if isinstance(prob.A, EllMatrix) else m * n
    gather_rows = 2 * nnz  # A@x gathers x per nnz; A^T r gathers r per nnz
    t_gather_1 = gather_rows * 32 / 3.35e12
    psum_bytes = 4 * m
    t_psum = max(psum_bytes / 450e9, 5e-6)  # NVLink bandwidth + latency floor
    rows = []
    for nb in blocks:
        t_n = t_gather_1 / nb + t_psum
        row = {
            "mesh_block": nb, "gather_rows_per_dev": gather_rows // nb,
            "psum_bytes": psum_bytes,
            "modeled_iters_per_sec": round(1.0 / t_n, 1),
            "modeled_efficiency": round(t_gather_1 / (nb * t_n), 3),
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


_PROC_WORKER = """
import os, sys, json
pid, nproc, port, cfg = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], json.loads(sys.argv[4])
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={cfg['local_devices']}"
import jax
jax.config.update("jax_platforms", "cpu")
from bsls_tpu.parallel.mesh import init_distributed
init_distributed(f"127.0.0.1:{port}", num_processes=nproc, process_id=pid)
assert jax.process_count() == nproc
import numpy as np
from bsls_tpu.models import synthetic
from bsls_tpu.models.synthetic import with_scenarios
from bsls_tpu.parallel import make_mesh, solve_sharded
import bsls_tpu as bsls

prob = synthetic.make_config(cfg["config"])
if prob.C is not None:
    prob = bsls.Problem(A=prob.A, b=prob.b, partition=prob.partition, name=prob.name)
prob = with_scenarios(prob, cfg["scenarios"])
mesh = make_mesh(block=nproc * cfg["local_devices"], scenario=1)
res = solve_sharded(prob, mesh, method="pgd", tol=0.0,
                    max_iter=cfg["max_iter"], chunk=cfg["chunk"])
if pid == 0:
    print("RESULT", json.dumps({
        "iters_per_sec": cfg["scenarios"] * res.steady_iters_per_sec(),
        "objective_max": float(np.max(np.asarray(res.objective))),
    }), flush=True)
"""


def run_processes(args):
    """True multi-process scaling row: N OS processes x local_devices
    virtual CPU devices through jax.distributed — exercises the real
    cross-process collective path (Gloo here, ICI/DCN on a pod).  All
    processes share one socket, so treat iters/s as a functional
    measurement, not interconnect efficiency."""
    import json as _json
    import socket
    import subprocess
    import sys as _sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    cfg = _json.dumps({
        "config": args.config, "scenarios": args.scenarios,
        "max_iter": args.max_iter, "chunk": args.chunk,
        "local_devices": max(8 // args.processes, 1),
    })
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [_sys.executable, "-c", _PROC_WORKER, str(pid), str(args.processes),
             port, cfg],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        )
        for pid in range(args.processes)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=1200)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(out[-2000:])
    line = [ln for ln in outs[0].splitlines() if ln.startswith("RESULT")][0]
    row = {"processes": args.processes, **json.loads(line[len("RESULT "):])}
    print(json.dumps(row), flush=True)
    return [row]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="medium")
    p.add_argument("--scenarios", type=int, default=8)
    p.add_argument("--blocks", type=int, nargs="+", default=[1, 2, 4, 8])
    p.add_argument("--max-iter", type=int, default=300)
    p.add_argument("--chunk", type=int, default=100)
    p.add_argument("--platform", default=None)
    p.add_argument("--analyze", action="store_true",
                   help="print the analytic comm/compute scaling model only")
    p.add_argument("--processes", type=int, default=0,
                   help="run ONE row with N real OS processes over an "
                        "8-virtual-CPU-device global mesh (jax.distributed)")
    args = p.parse_args(argv)

    if args.analyze:
        return analyze(args.config, args.blocks)
    if args.processes:
        return run_processes(args)

    if args.platform == "cpu8":
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
        ).strip()
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    if args.platform == "cpu8":
        jax.config.update("jax_platforms", "cpu")

    from bsls_tpu.models import synthetic
    from bsls_tpu.models.synthetic import with_scenarios
    from bsls_tpu.parallel import make_mesh, solve_sharded

    prob = synthetic.make_config(args.config)
    if prob.C is not None:
        import bsls_tpu as bsls

        prob = bsls.Problem(A=prob.A, b=prob.b, partition=prob.partition, name=prob.name)
    prob = with_scenarios(prob, args.scenarios)

    results = []
    base_ips = None
    for nb in args.blocks:
        if nb > len(jax.devices()):
            break
        mesh = make_mesh(block=nb, scenario=1, devices=jax.devices()[:nb])
        res = solve_sharded(prob, mesh, method="pgd", tol=0.0,
                            max_iter=args.max_iter, chunk=args.chunk)
        ips = args.scenarios * res.steady_iters_per_sec()
        if base_ips is None:
            base_ips = ips
        eff = ips / base_ips / nb
        row = {
            "mesh_block": nb, "iters_per_sec": round(ips, 2),
            "speedup": round(ips / base_ips, 3), "efficiency": round(eff, 3),
            "objective_max": float(np.max(np.asarray(res.objective))),
        }
        results.append(row)
        print(json.dumps(row), flush=True)
    return results


if __name__ == "__main__":
    main()
