"""True multi-process distributed tests (SURVEY.md §4b: "multi-process
single-host tests via jax.distributed.initialize").

Two OS processes, each owning 4 virtual CPU devices, bootstrap through
``parallel.mesh.init_distributed`` (the same entry a pod uses), build one
global 8-device mesh, and run ``solve_sharded`` end-to-end — exercising
cross-process collectives (Gloo) AND the non-addressable-shard host
readbacks (``to_host``/process_allgather) that a transparently-gathering
single-process run never hits.

Every worker asserts ``jax.process_count() == nproc`` after bootstrap:
``init_distributed`` deliberately swallows re-init errors, so without the
assert a failed bootstrap (port in use) would silently degrade these tests
to two independent single-process runs that vacuously pass.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

# 2-OS-process Gloo tests dominate suite wall time -> milestone-only
pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# shared bootstrap: 4 local virtual devices, distributed init, hard assert
_BOOT = """
import os, sys
pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
from bsls_tpu.parallel.mesh import init_distributed
init_distributed(f"127.0.0.1:{port}", num_processes=nproc, process_id=pid)
assert jax.process_count() == nproc, jax.process_count()
import numpy as np
"""

_WORKER = _BOOT + """
from bsls_tpu.parallel import make_mesh, solve_sharded
from bsls_tpu.models import synthetic

prob = synthetic.tiny_dense(seed=0, num_blocks=32, dim=4, m=128)
mesh = make_mesh(block=8, scenario=1)
res = solve_sharded(prob, mesh, method="pgd", tol=1e-7, max_iter=400, chunk=100)
print("RESULT", float(np.asarray(res.objective).max()),
      float(np.abs(np.asarray(res.x)).sum()), flush=True)
"""

_WORKER_CKPT = _BOOT + """
ckpt, phase = sys.argv[4], sys.argv[5]
from bsls_tpu.parallel import make_mesh, solve_sharded
from bsls_tpu.models import synthetic

prob = synthetic.tiny_dense(seed=0, num_blocks=32, dim=4, m=128)
mesh = make_mesh(block=8, scenario=1)
if phase == "first":
    res = solve_sharded(prob, mesh, method="pgd", tol=0.0, max_iter=200,
                        chunk=50, checkpoint_path=ckpt, checkpoint_every=1)
else:
    res = solve_sharded(prob, mesh, method="pgd", tol=0.0, max_iter=400,
                        chunk=50, checkpoint_path=ckpt, checkpoint_every=1,
                        resume=True)
print("RESULT", float(np.asarray(res.objective).max()), res.iterations, flush=True)
"""

_WORKER_EQ = _BOOT + """
from bsls_tpu.parallel import make_mesh
from bsls_tpu.models import synthetic
from bsls_tpu.solvers.eq_constrained import solve_equality_constrained

prob = synthetic.traffic_like(seed=4, num_blocks=32, m=64, num_eq=4, noise=0.0)
mesh = make_mesh(block=8, scenario=1)
res = solve_equality_constrained(prob, method="apgd", mesh=mesh, tol=1e-6,
                                 max_iter=2000, chunk=100)
print("RESULT", float(np.asarray(res.objective).max()), res.eq_violation, flush=True)
"""

_WORKER_EQ_CKPT = _BOOT + """
ckpt, phase = sys.argv[4], sys.argv[5]
from bsls_tpu.parallel import make_mesh
from bsls_tpu.models import synthetic
from bsls_tpu.solvers.eq_constrained import solve_equality_constrained

prob = synthetic.traffic_like(seed=4, num_blocks=32, m=64, num_eq=4, noise=0.0)
mesh = make_mesh(block=8, scenario=1)
if phase == "first":
    res = solve_equality_constrained(
        prob, method="apgd", mesh=mesh, tol=1e-6, outer_iters=2,
        inner_iters=400, chunk=100, checkpoint_path=ckpt, checkpoint_every=1)
else:
    res = solve_equality_constrained(
        prob, method="apgd", mesh=mesh, tol=1e-6, outer_iters=12,
        inner_iters=2000, chunk=100, checkpoint_path=ckpt, resume=True)
print("RESULT", float(np.asarray(res.objective).max()), res.eq_violation,
      flush=True)
"""

_WORKER_LAYOUTS = _BOOT + """
from bsls_tpu.parallel import make_mesh, solve_sharded
from bsls_tpu.models import synthetic

# row-sharded ELL (the SP/CP analog) over a cross-process block axis
prob = synthetic.medium_sparse(seed=3, num_blocks=16, m=64)
mesh = make_mesh(block=8, scenario=1)
r1 = solve_sharded(prob, mesh, method="pgd", tol=1e-7, max_iter=300,
                   chunk=100, shard_rows=True)
# 2-D (row x col) grid + scenario axis, all spanning processes
mesh2 = make_mesh(row=2, block=2, scenario=2)
p2 = synthetic.large_sharded(seed=5, num_blocks=16, dim=4, m=64,
                             num_scenarios=2, block_multiple=2, noise=1e-3)
r2 = solve_sharded(p2, mesh2, method="pgd", tol=1e-7, max_iter=200, chunk=50)
print("RESULT", float(np.asarray(r1.objective).max()),
      float(np.asarray(r2.objective).max()), flush=True)
"""


def _free_port() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def _run_pair(script, extra_args=(), timeout=240):
    """Run the worker under 2 processes on a fresh coordinator port; kill
    stragglers on any failure so a deadlock can't leak workers (or keep a
    port bound) into later tests."""
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS",)}
    env["JAX_PLATFORMS"] = "cpu"
    args = ["2", _free_port()] + list(extra_args)
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", script, str(pid)] + args,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            cwd=REPO, env=env, text=True,
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]
    return [
        [ln for ln in out.splitlines() if ln.startswith("RESULT")][0].split()[1:]
        for out in outs
    ]


def test_two_process_solve_matches_single_process():
    vals = _run_pair(_WORKER)
    # both processes must agree bit-for-bit on the gathered result
    assert vals[0] == vals[1], vals

    # and match the single-(this-)process solve of the same instance
    from bsls_tpu.models import synthetic
    from bsls_tpu.parallel import make_mesh, solve_sharded

    prob = synthetic.tiny_dense(seed=0, num_blocks=32, dim=4, m=128)
    mesh = make_mesh(block=8, scenario=1)
    ref = solve_sharded(prob, mesh, method="pgd", tol=1e-7, max_iter=400, chunk=100)
    np.testing.assert_allclose(float(vals[0][0]),
                               float(np.asarray(ref.objective).max()),
                               rtol=1e-5, atol=1e-8)


def test_two_process_checkpoint_resume(tmp_path):
    """Per-process shard dumps + resume across a 2-process mesh: run 200
    iters with per-chunk checkpoints, then a fresh 2-process job resumes
    from the per-proc files and continues to 400."""
    import glob as _glob

    ckpt = str(tmp_path / "dist_ck.npz")
    _run_pair(_WORKER_CKPT, [ckpt, "first"])
    assert _glob.glob(str(tmp_path / "dist_ck*.proc0.npz"))
    assert _glob.glob(str(tmp_path / "dist_ck*.proc1.npz"))
    vals = _run_pair(_WORKER_CKPT, [ckpt, "resume"])
    assert vals[0] == vals[1], vals
    f_res, it_res = float(vals[0][0]), int(vals[0][1])
    assert it_res == 400

    # straight 400-iteration single-process reference on the same mesh
    from bsls_tpu.models import synthetic
    from bsls_tpu.parallel import make_mesh, solve_sharded

    prob = synthetic.tiny_dense(seed=0, num_blocks=32, dim=4, m=128)
    mesh = make_mesh(block=8, scenario=1)
    ref = solve_sharded(prob, mesh, method="pgd", tol=0.0, max_iter=400, chunk=50)
    np.testing.assert_allclose(f_res, float(np.asarray(ref.objective).max()),
                               rtol=1e-5, atol=1e-8)


def test_two_process_equality_constrained():
    """The AL outer loop round-trips host<->device every outer (gathered
    violation check, re-injected warm start) — all of it must survive a
    mesh that spans processes."""
    vals = _run_pair(_WORKER_EQ)
    assert vals[0] == vals[1], vals
    assert float(vals[0][1]) <= 1e-4  # eq violation
    assert float(vals[0][0]) <= 1e-6  # noiseless planted x => f* ~ 0


def test_two_process_eq_checkpoint_resume(tmp_path):
    """AL-level checkpoint/resume across a 2-process mesh: a run truncated at 2 outers checkpoints (lam, x, rho); a fresh
    2-process job resumes the multipliers and converges."""
    import glob as _glob

    ckpt = str(tmp_path / "eq_ck.npz")
    _run_pair(_WORKER_EQ_CKPT, [ckpt, "first"])
    assert _glob.glob(str(tmp_path / "eq_ck*.npz"))
    vals = _run_pair(_WORKER_EQ_CKPT, [ckpt, "resume"])
    assert vals[0] == vals[1], vals
    assert float(vals[0][1]) <= 1e-4  # eq violation
    assert float(vals[0][0]) <= 1e-6  # noiseless planted x => f* ~ 0


def test_two_process_row_and_2d_layouts():
    """Row-sharded ELL and the 2-D (row x col x scenario) grid must run
    when every mesh axis spans OS processes."""
    vals = _run_pair(_WORKER_LAYOUTS)
    assert vals[0] == vals[1], vals
    assert all(np.isfinite(float(v)) for v in vals[0])
