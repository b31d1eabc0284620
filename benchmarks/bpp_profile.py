#!/usr/bin/env python
"""Profile prox_bpp_polish wall time vs KKT dimension .

For each target KKT dimension: build a traffic-like eq instance, AL-solve it
(fp32, CPU), then time the BPP polish twice — COLD (from the AL iterate) and
WARM (from the polished point against a 2%-perturbed RHS, the serving
sensitivity pattern).  Reports per-size rows with both the dense-LAPACK and
sparse projected-PCG face-solve paths where each applies, so `dense_kkt`
(the crossover) and `max_kkt` (the ceiling) are chosen from data.

    python benchmarks/bpp_profile.py --sizes 500,1000,2000,3000,6000
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--sizes", default="500,1000,2000,3000,6000,12000,24000",
                   help="target KKT dimensions (n + B + p)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import bsls_tpu as bsls
    from bsls_tpu.models import synthetic
    from bsls_tpu.solvers.eq_constrained import (
        eq_dual_bound, prox_bpp_polish)

    for kkt_target in [int(s) for s in args.sizes.split(",")]:
        # avg block dim ~7 -> num_blocks ~ kkt/8; p scales mildly
        nb = max(10, kkt_target // 8)
        m = max(60, kkt_target // 3)
        p_eq = max(4, kkt_target // 120)
        prob = synthetic.traffic_like(num_blocks=nb, m=m, num_eq=p_eq,
                                      noise=5e-3, seed=11)
        n = prob.partition.n_flat
        kkt = n + nb + p_eq
        print(f"# kkt={kkt} (n={n} B={nb} p={p_eq}) solving AL...",
              file=sys.stderr, flush=True)
        res = bsls.solve(prob, method="apgd", tol=1e-6, max_iter=10000,
                         chunk=200)
        x0 = np.asarray(res.x, np.float64)
        row = {"kkt_dim": kkt, "n": n, "blocks": nb, "p": p_eq,
               "al_viol": float(res.eq_violation)}
        for label, kw in (("dense", dict(dense_kkt=10**9)),
                          ("sparse", dict(dense_kkt=0))):
            if label == "dense" and kkt > 8000:
                continue  # O(kkt^3) per exchange: measured impractical
            t = time.perf_counter()
            xp, lam, ok = prox_bpp_polish(prob, x0, **kw)
            cold = time.perf_counter() - t
            if not ok:
                row[label] = {"ok": False, "cold_s": round(cold, 2)}
                continue
            bound = eq_dual_bound(prob, xp, lam)
            # warm: perturbed RHS from the polished point (serving pattern)
            rng = np.random.default_rng(3)
            import dataclasses

            b2 = np.asarray(prob.b) + 0.02 * rng.standard_normal(
                prob.b.shape) * float(np.abs(prob.b).mean())
            prob2 = dataclasses.replace(prob, b=b2, x_true=None)
            t = time.perf_counter()
            xw, lamw, okw = prox_bpp_polish(prob2, xp, **kw)
            warm = time.perf_counter() - t
            row[label] = {
                "ok": True, "cold_s": round(cold, 2),
                "bound": float(bound), "warm_ok": bool(okw),
                "warm_s": round(warm, 2),
                "warm_bound": (float(eq_dual_bound(prob2, xw, lamw))
                               if okw else None),
            }
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()
