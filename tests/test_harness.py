"""Harness tests: config presets, metrics JSONL, checkpoint/resume
(including the kill-and-resume fault-injection equivalent), benchmark CLI,
and the C-baseline runner."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import bsls_tpu as bsls
from bsls_tpu.models import synthetic
from bsls_tpu.utils.checkpoint import load_state, save_state
from bsls_tpu.utils.config import PRESETS, load_config
from bsls_tpu.utils.metrics import MetricsWriter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_config_presets_and_overrides():
    cfg = load_config("medium-pgd", tol=1e-4, method="apgd")
    assert cfg.config == "medium" and cfg.method == "apgd" and cfg.tol == 1e-4
    assert set(PRESETS) >= {"tiny", "medium-pgd", "medium-eg", "traffic", "large"}


def test_on_disk_config_presets_match_in_code():
    """configs/*.json (SURVEY §7 API sketch) mirror utils.config.PRESETS."""
    import dataclasses

    cfg_dir = os.path.join(REPO, "configs")
    files = {f[:-5] for f in os.listdir(cfg_dir) if f.endswith(".json")}
    assert files == set(PRESETS), (files, set(PRESETS))
    for name in PRESETS:
        cfg = load_config(os.path.join(cfg_dir, name + ".json"))
        assert dataclasses.asdict(cfg) == dataclasses.asdict(PRESETS[name]), name


def test_metrics_writer(tmp_path):
    path = str(tmp_path / "m.jsonl")
    with MetricsWriter(path) as mw:
        mw.log("chunk", iteration=10, f=1.5)
        mw.log("result", objective=0.1)
    recs = [json.loads(l) for l in open(path)]
    assert recs[0]["kind"] == "chunk" and recs[0]["iteration"] == 10
    assert all("ts" in r for r in recs)


def test_checkpoint_roundtrip(tmp_path):
    import jax.numpy as jnp

    state = {"a": jnp.arange(5.0), "b": (jnp.zeros((2, 2)), jnp.asarray(3))}
    path = str(tmp_path / "ck.npz")
    save_state(path, state, meta={"iteration": 42})
    back, meta = load_state(path, state)
    assert meta["iteration"] == 42
    np.testing.assert_allclose(np.asarray(back["a"]), np.arange(5.0))
    # shape mismatch is rejected
    bad = {"a": jnp.arange(6.0), "b": (jnp.zeros((2, 2)), jnp.asarray(3))}
    with pytest.raises(ValueError):
        load_state(path, bad)


def test_solve_checkpoint_resume(tmp_path):
    """Fault-injection equivalent: stop a solve mid-run, resume, and reach
    the same objective as an uninterrupted run."""
    prob = synthetic.tiny_dense(seed=1, num_blocks=20, dim=6, m=150)
    ck = str(tmp_path / "solve_ck.npz")
    full = bsls.solve(prob, method="pgd", tol=0.0, max_iter=400, chunk=100)
    # run half, "crash", then resume the rest
    bsls.solve(prob, method="pgd", tol=0.0, max_iter=200, chunk=100,
               checkpoint_path=ck, checkpoint_every=1)
    assert os.path.exists(ck)
    resumed = bsls.solve(prob, method="pgd", tol=0.0, max_iter=400, chunk=100,
                         checkpoint_path=ck, checkpoint_every=1, resume=True)
    np.testing.assert_allclose(
        float(resumed.objective), float(full.objective), rtol=1e-5, atol=1e-8
    )
    # resuming past max_iter is a no-op that still returns a valid result
    noop = bsls.solve(prob, method="pgd", tol=0.0, max_iter=400, chunk=100,
                      checkpoint_path=ck, checkpoint_every=1, resume=True)
    assert noop.trace_f.size == 0
    np.testing.assert_allclose(float(noop.objective), float(full.objective), rtol=1e-5)


def test_checkpoint_rotation(tmp_path):
    import jax.numpy as jnp

    state = {"a": jnp.arange(4.0)}
    path = str(tmp_path / "rot.npz")
    for it in (100, 200, 300, 400):
        save_state(path, state, meta={"iteration": it}, keep=2)
    import glob

    files = sorted(glob.glob(str(tmp_path / "rot.it*.npz")))
    assert [os.path.basename(f) for f in files] == [
        "rot.it000000300.npz", "rot.it000000400.npz"
    ]
    from bsls_tpu.utils.checkpoint import latest_checkpoint

    best = latest_checkpoint(path)
    assert best.endswith("rot.it000000400.npz")
    _, meta = load_state(best, state)
    assert meta["iteration"] == 400


def test_checkpoint_dtype_mismatch_rejected(tmp_path):
    import jax.numpy as jnp

    state = {"a": jnp.arange(5.0, dtype=jnp.float32)}
    path = str(tmp_path / "dt.npz")
    save_state(path, state)
    bad = {"a": jnp.arange(5, dtype=jnp.int32)}
    with pytest.raises(ValueError, match="dtype"):
        load_state(path, bad)


def test_checkpoint_sharded_leaves(tmp_path):
    """Pod-ready format: sharded leaves dump shard-by-shard (keyed by global
    offset) and reassemble on load — exercised on the 8-virtual-device mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 simulated devices")
    from bsls_tpu.parallel import make_mesh

    mesh = make_mesh(block=4, scenario=2, devices=jax.devices()[:8])
    x = jnp.arange(64.0).reshape(8, 8)
    xs = jax.device_put(x, NamedSharding(mesh, P("block", "scenario")))
    state = {"x": xs, "scalar": jnp.asarray(7)}
    path = str(tmp_path / "sh.npz")
    save_state(path, state, meta={"iteration": 1})
    raw = np.load(path, allow_pickle=False)
    shard_keys = [k for k in raw.files if "_s" in k and k.startswith("leaf")]
    assert len(shard_keys) >= 8  # per-shard dumps, not a gathered blob
    back, _ = load_state(path, state)
    np.testing.assert_array_equal(np.asarray(back["x"]), np.asarray(x))


def test_kill_and_resume(tmp_path):
    """REAL fault injection: SIGKILL a solver subprocess mid-run, then
    resume from its last atomic checkpoint and match the uninterrupted
    objective."""
    import signal
    import time

    ck = str(tmp_path / "kill_ck.npz")
    script = f"""
import jax
jax.config.update("jax_platforms", "cpu")
import bsls_tpu as bsls
from bsls_tpu.models import synthetic
import time
prob = synthetic.tiny_dense(seed=1, num_blocks=20, dim=6, m=150)
# throttle chunks so the parent's SIGKILL lands well before iteration 400
# (resume-from-any-checkpoint < 400 is trajectory-identical; overshooting
# 400 would make the resumed run better than the 400-iter reference)
bsls.solve(prob, method="pgd", tol=0.0, max_iter=100000, chunk=50,
           checkpoint_path={ck!r}, checkpoint_every=1,
           callback=lambda it, st: time.sleep(0.3))
"""
    proc = subprocess.Popen(
        [sys.executable, "-c", script],
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    try:
        deadline = time.time() + 240
        while time.time() < deadline and not os.path.exists(ck):
            if proc.poll() is not None:
                raise AssertionError("subprocess exited before first checkpoint")
            time.sleep(0.25)
        assert os.path.exists(ck), "no checkpoint appeared within budget"
        os.kill(proc.pid, signal.SIGKILL)  # exact PID, never a pattern
    finally:
        proc.wait(timeout=30)

    prob = synthetic.tiny_dense(seed=1, num_blocks=20, dim=6, m=150)
    full = bsls.solve(prob, method="pgd", tol=0.0, max_iter=400, chunk=50)
    resumed = bsls.solve(prob, method="pgd", tol=0.0, max_iter=400, chunk=50,
                         checkpoint_path=ck, checkpoint_every=1, resume=True)
    np.testing.assert_allclose(
        float(resumed.objective), float(full.objective), rtol=1e-5, atol=1e-8
    )


def test_installed_cli_module(tmp_path):
    """`python -m bsls_tpu` is the installed CLI surface — must work from
    any cwd (no repo-relative path assumptions)."""
    out = subprocess.run(
        [sys.executable, "-m", "bsls_tpu", "--config", "tiny", "--method",
         "pgd", "--max-iter", "300", "--platform", "cpu"],
        capture_output=True, text=True, cwd=str(tmp_path), timeout=300,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(
            p for p in (REPO, os.environ.get("PYTHONPATH")) if p)},
    )
    assert out.returncode == 0, out.stderr[-1500:]
    row = json.loads(out.stdout.strip().splitlines()[-1])
    assert row["method"] == "pgd" and np.isfinite(row["objective"])


def test_aot_executable_cache_prevents_recompiles():
    """Repeat solve() calls with identical shapes/options must reuse ONE
    AOT chunk executable — the eq-constrained AL loop calls solve once per
    outer and used to recompile every time."""
    from bsls_tpu.solvers import base as base_mod

    prob = synthetic.tiny_dense(seed=0, num_blocks=12, dim=4, m=48)
    base_mod._AOT_CACHE.clear()
    bsls.solve(prob, method="lbfgs", tol=0.0, max_iter=20, chunk=10)
    n1 = len(base_mod._AOT_CACHE)
    assert n1 >= 1
    bsls.solve(prob, method="lbfgs", tol=0.0, max_iter=20, chunk=10)
    assert len(base_mod._AOT_CACHE) == n1, "second identical solve recompiled"
    # different static options -> a distinct executable
    bsls.solve(prob, method="lbfgs", tol=0.0, max_iter=20, chunk=10, lbfgs_mem=2)
    assert len(base_mod._AOT_CACHE) == n1 + 1


def test_benchmark_cli_tiny(tmp_path):
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "benchmarks", "run.py"),
         "--config", "tiny", "--method", "apgd", "--max-iter", "600",
         "--chunk", "200", "--tol", "1e-7", "--oracle",
         "--metrics", str(tmp_path / "m.jsonl"), "--platform", "cpu"],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["rel_gap_vs_oracle"] <= 1e-5
    assert res["iters_per_sec"] > 0
    assert res["time_to_1e-6_gap_s"] is not None
    recs = [json.loads(l) for l in open(tmp_path / "m.jsonl")]
    assert any(r["kind"] == "result" for r in recs)


def test_c_baseline_matches_oracle_objective():
    """The C baseline solver must converge to the same optimum (parity of
    the measured denominator)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "baseline_runner", os.path.join(REPO, "benchmarks", "baseline_c", "runner.py")
    )
    runner = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(runner)
    # well-conditioned instance (uniform demands): plain PGD, like the
    # reference's, converges; the demand-scaled configs need this build's
    # equilibration, which the C baseline intentionally lacks
    import scipy.sparse as sp

    rng = np.random.default_rng(3)
    sizes = rng.integers(2, 7, size=100)
    n = int(sizes.sum())
    A = sp.random(800, n, density=0.02, random_state=3, format="csr")
    x_true = np.concatenate([rng.dirichlet(np.ones(s)) for s in sizes])
    b = A @ x_true + 1e-3 * rng.standard_normal(800)
    prob = bsls.Problem.from_arrays(A, b, sizes)
    res = runner.run_baseline(prob, iters=3000)
    from bsls_tpu.models import oracle_solve

    orc = oracle_solve(prob, tol_gap=1e-9, max_iter=20000)
    rel = (res["objective"] - orc.objective) / max(1.0, orc.objective)
    assert rel <= 1e-5, (res["objective"], orc.objective)


def test_compile_cache_enable(monkeypatch):
    """Without JAX_COMPILATION_CACHE_DIR the cache lands in the one fixed
    in-checkout directory; idempotent."""
    import jax

    from bsls_tpu.utils import compile_cache as cc

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        assert cc.DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")
        assert cc.enable_compile_cache() == cc.DEFAULT_CACHE_DIR
        assert jax.config.jax_compilation_cache_dir == cc.DEFAULT_CACHE_DIR
        assert os.path.isdir(cc.DEFAULT_CACHE_DIR)
        assert cc.enable_compile_cache() == cc.DEFAULT_CACHE_DIR
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env(tmp_path, monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set, the helper uses it and sets no
    directory of its own."""
    import jax

    from bsls_tpu.utils import compile_cache as cc

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jx"))
    before = jax.config.jax_compilation_cache_dir
    assert cc.enable_compile_cache() == str(tmp_path / "jx")
    assert jax.config.jax_compilation_cache_dir == before


@pytest.mark.slow
def test_time_to_gap_multi_rhs(tmp_path):
    """The honest multi-RHS metric: --scenarios S builds certified
    per-scenario references and requires EVERY scenario to cross tol."""
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "benchmarks", "time_to_gap.py"),
         "--config", "tiny", "--methods", "pgd/bb", "--scenarios", "3",
         "--refine", "2", "--platform", "cpu"],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu",
             "BSLS_CACHE_DIR": str(tmp_path)},
    )
    assert out.returncode == 0, out.stderr[-2000:]
    row = json.loads(out.stdout.strip().splitlines()[-1])
    assert row["scenarios"] == 3 and len(row["f_star"]) == 3
    # reference soundness: the f64 FW-gap certificate must pin each
    # per-scenario reference far below the tolerance being measured
    assert row["ref_fw_gap_rel"] < 1e-7
    assert row["cross_iter_le"] is not None
    assert row["rel_gap_at_cross"] <= row["tol"]
    assert (tmp_path / "oracle_tiny_0_x3.json").exists()


@pytest.mark.slow
def test_time_to_gap_keep_eq(tmp_path):
    """Config-3 honest metric: --keep-eq measures the certified
    equality-constrained solve end-to-end (AL + active-set finisher)
    against the certified eq oracle, reporting wall time only when both
    the f64 objective gap and the constraint violation cross tol."""
    prob = synthetic.traffic_like(seed=0, num_blocks=24, m=48, num_eq=3,
                                  noise=0.0)
    path = str(tmp_path / "eq_instance.npz")
    prob.save_npz(path)
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "benchmarks", "time_to_gap.py"),
         "--config", path, "--keep-eq", "--methods", "apgd",
         "--platform", "cpu"],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu",
             "BSLS_CACHE_DIR": str(tmp_path)},
    )
    assert out.returncode == 0, out.stderr[-2000:]
    row = json.loads(out.stdout.strip().splitlines()[-1])
    assert row["eq"] is True and row["ref"] == "eq_oracle"
    assert row["time_to_gap_s"] is not None  # crossed: gap AND violation
    assert row["rel_gap"] <= row["tol"]
    assert row["eq_violation"] <= row["tol"]
    assert row["refine_fw_gap"] <= 1e-6  # sound dual-bound certificate
