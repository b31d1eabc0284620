"""Distributed tests on the simulated 8-device CPU mesh (SURVEY.md §4b).

Asserts the sharded solve is numerically equivalent (fp tolerance) to the
single-device solve, exercising both mesh axes and the psum residual path.
"""
import jax
import numpy as np
import pytest

import bsls_tpu as bsls
from bsls_tpu.models import synthetic
from bsls_tpu.parallel import make_mesh, shard_problem, solve_sharded


@pytest.fixture(scope="module")
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 simulated devices")
    return jax.devices()[:8]


def _uniform_prob(num_blocks=64, dim=8, m=256, S=None, seed=0):
    if S:
        return synthetic.large_sharded(
            seed=seed, num_blocks=num_blocks, dim=dim, m=m, num_scenarios=S,
            block_multiple=8, noise=1e-3,
        )
    p = synthetic.large_sharded(
        seed=seed, num_blocks=num_blocks, dim=dim, m=m, num_scenarios=1,
        block_multiple=8, noise=1e-3,
    )
    return bsls.Problem(A=p.A, b=p.b[0], partition=p.partition, name="single")


def test_shard_problem_layout(eight_devices):
    mesh = make_mesh(block=4, scenario=2, devices=eight_devices)
    prob = _uniform_prob(S=2)
    dp, part = shard_problem(prob, mesh)
    assert dp.reduce_axis == "block"
    # bucket rows divisible by block axis
    for bk in dp.buckets:
        assert bk.mask.shape[0] % 4 == 0
    # sharding really applied
    s = dp.buckets[0].mask.sharding
    assert s.spec[0] == "block"


# EG/FW converge sublinearly and their fixed step uses the power-iteration
# L estimate, whose random start vector necessarily differs between the
# sharded and single-device paths — mid-trajectory objectives can differ at
# the ~1% level while both converge to the same optimum.  PGD/APGD use the
# exact line search and must agree tightly.
@pytest.mark.parametrize(
    "method,rtol",
    [("pgd", 5e-4), ("apgd", 5e-4), ("lbfgs", 5e-4), ("eg", 2e-2),
     ("frank_wolfe", 2e-2)],
)
def test_sharded_matches_single_device(eight_devices, method, rtol):
    mesh = make_mesh(block=8, scenario=1, devices=eight_devices)
    prob = _uniform_prob()
    res1 = bsls.solve(prob, method=method, tol=1e-7, max_iter=600, chunk=100)
    res8 = solve_sharded(prob, mesh, method=method, tol=1e-7, max_iter=600, chunk=100)
    f1 = float(np.asarray(res1.objective))
    f8 = float(np.asarray(res8.objective))
    np.testing.assert_allclose(f8, f1, rtol=rtol, atol=1e-5)
    if method in ("pgd", "apgd"):
        np.testing.assert_allclose(res8.x, res1.x, atol=5e-4)


def test_sharded_both_axes_multi_rhs(eight_devices):
    """Fixed budget and one shared Lipschitz bound: a tol-stopped solve
    keeps the state of the last chunk ENQUEUED when the stop decision is
    read, and the async loop's sync cadence follows host wall time, so
    under load two tol-stopped runs end at different iterations."""
    from bsls_tpu.ops import layout as OL
    from bsls_tpu.solvers.base import power_lipschitz

    mesh = make_mesh(block=4, scenario=2, devices=eight_devices)
    prob = _uniform_prob(S=4)
    lip = float(np.asarray(power_lipschitz(OL.prepare(prob))))
    kw = dict(method="apgd", tol=0.0, max_iter=800, chunk=100, lipschitz=lip)
    res = solve_sharded(prob, mesh, **kw)
    assert res.x.shape == (4, prob.partition.n_flat)
    assert res.iterations == 800
    # matches unsharded vmapped solve per scenario
    res0 = bsls.solve(prob, **kw)
    np.testing.assert_allclose(
        np.asarray(res.objective), np.asarray(res0.objective), rtol=5e-4, atol=1e-5
    )


def test_row_sharded_matches_single_device(eight_devices):
    """SP/CP-analog: dense A rows + r sharded, x replicated; psum'd A^T r."""
    mesh = make_mesh(block=8, scenario=1, devices=eight_devices)
    prob = synthetic.tiny_dense(seed=4, num_blocks=32, dim=8, m=333)  # m % 8 != 0: pad path
    res1 = bsls.solve(prob, method="pgd", tol=1e-7, max_iter=400, chunk=100)
    res8 = solve_sharded(prob, mesh, method="pgd", tol=1e-7, max_iter=400,
                         chunk=100, shard_rows=True)
    np.testing.assert_allclose(
        float(np.asarray(res8.objective)), float(np.asarray(res1.objective)),
        rtol=5e-4, atol=1e-6,
    )
    np.testing.assert_allclose(res8.x, res1.x, atol=5e-4)


def test_row_sharded_apgd_both_axes(eight_devices):
    mesh = make_mesh(block=4, scenario=2, devices=eight_devices)
    prob = synthetic.tiny_dense(seed=5, num_blocks=16, dim=4, m=96)
    from bsls_tpu.models.synthetic import with_scenarios

    prob = with_scenarios(prob, 4, seed=2)
    res = solve_sharded(prob, mesh, method="apgd", tol=1e-7, max_iter=400,
                        chunk=100, shard_rows=True)
    res0 = bsls.solve(prob, method="apgd", tol=1e-7, max_iter=400, chunk=100)
    np.testing.assert_allclose(
        np.asarray(res.objective), np.asarray(res0.objective), rtol=1e-3, atol=1e-6
    )


@pytest.mark.slow
def test_row_sharded_ell_matches_single_device(eight_devices):
    """SP/CP-analog for SPARSE A: per-shard dual-ELL re-encoding (local row
    ids on the column orientation, global PF cols on the row orientation)."""
    mesh = make_mesh(block=8, scenario=1, devices=eight_devices)
    prob = synthetic.medium_sparse(seed=7, num_blocks=120, m=1000)
    assert prob.A.shape[0] % 8 == 0  # also exercise the non-padded path
    res1 = bsls.solve(prob, method="pgd", tol=1e-7, max_iter=300, chunk=100)
    res8 = solve_sharded(prob, mesh, method="pgd", tol=1e-7, max_iter=300,
                         chunk=100, shard_rows=True)
    np.testing.assert_allclose(
        float(np.asarray(res8.objective)), float(np.asarray(res1.objective)),
        rtol=5e-4, atol=1e-6,
    )
    np.testing.assert_allclose(res8.x, res1.x, atol=5e-4)


@pytest.mark.slow
def test_row_sharded_ell_padded_rows_multi_rhs(eight_devices):
    """ELL row sharding with m % 8 != 0 (zero-row padding) + scenario axis."""
    mesh = make_mesh(block=4, scenario=2, devices=eight_devices)
    prob = synthetic.medium_sparse(seed=8, num_blocks=80, m=777)
    from bsls_tpu.models.synthetic import with_scenarios

    prob = with_scenarios(prob, 4, seed=3)
    res = solve_sharded(prob, mesh, method="apgd", tol=1e-7, max_iter=300,
                        chunk=100, shard_rows=True)
    res0 = bsls.solve(prob, method="apgd", tol=1e-7, max_iter=300, chunk=100)
    np.testing.assert_allclose(
        np.asarray(res.objective), np.asarray(res0.objective), rtol=5e-3, atol=1e-6
    )


def test_sharded_afw_matches_single_device(eight_devices):
    """Pairwise-FW's per-block away logic under the block-sharded mesh.

    AFW makes DISCRETE vertex selections (argmax over supp(x)), so fp
    reduction-order differences between the psum'd and single-device paths
    eventually flip a selection and the trajectories legitimately diverge.
    Compare the early trajectory (before divergence) tightly, and the long
    run only as "both converge to comparable quality"."""
    mesh = make_mesh(block=8, scenario=1, devices=eight_devices)
    prob = _uniform_prob(seed=9)
    res1 = bsls.solve(prob, method="afw", tol=0.0, max_iter=30, chunk=10)
    res8 = solve_sharded(prob, mesh, method="afw", tol=0.0, max_iter=30, chunk=10)
    t1 = np.asarray(res1.trace_f).reshape(-1)
    t8 = np.asarray(res8.trace_f).reshape(-1)
    # iteration 1 is selection-free arithmetic: must agree tightly; later
    # iterations only loosely (fp ties flip argmin/argmax selections)
    np.testing.assert_allclose(t8[0], t1[0], rtol=1e-4)
    np.testing.assert_allclose(t8[:10], t1[:10], rtol=0.1)
    ref = bsls.solve(prob, method="pgd", tol=1e-8, max_iter=1500, chunk=300)
    long8 = solve_sharded(prob, mesh, method="afw", tol=1e-8, max_iter=1500, chunk=300)
    f_ref, f8 = float(np.asarray(ref.objective)), float(np.asarray(long8.objective))
    assert f8 <= f_ref * 1.5 + 1e-5, (f8, f_ref)


@pytest.mark.slow
def test_sharded_ragged_blocks(eight_devices):
    mesh = make_mesh(block=8, scenario=1, devices=eight_devices)
    prob = synthetic.traffic_like(num_blocks=64, m=200, num_eq=0, noise=1e-3)
    prob = bsls.Problem(A=prob.A, b=prob.b, partition=prob.partition)
    res1 = bsls.solve(prob, method="pgd", tol=1e-7, max_iter=400, chunk=100)
    res8 = solve_sharded(prob, mesh, method="pgd", tol=1e-7, max_iter=400, chunk=100)
    np.testing.assert_allclose(
        float(np.asarray(res8.objective)), float(np.asarray(res1.objective)), rtol=1e-3
    )
    # multi-bucket extraction must return the same solution in user order
    # (catches device-major vs bucket-major ordering bugs)
    np.testing.assert_allclose(res8.x, res1.x, atol=2e-3)
    f_from_x = prob.objective_np(np.asarray(res8.x, np.float64))
    np.testing.assert_allclose(f_from_x, float(np.asarray(res8.objective)), rtol=1e-3)


@pytest.mark.slow
def test_sharded_equality_constrained(eight_devices):
    """AL outer loop over mesh-sharded inner solves (stacked operator)."""
    mesh = make_mesh(block=4, scenario=1, devices=eight_devices[:4])
    prob = synthetic.traffic_like(num_blocks=40, m=200, num_eq=10, noise=0.0)
    r0 = bsls.solve(prob, method="apgd", tol=1e-7, max_iter=3000, chunk=200)
    r4 = bsls.solve(prob, method="apgd", tol=1e-7, max_iter=3000, chunk=200, mesh=mesh)
    assert r4.eq_violation is not None and r4.eq_violation <= 1e-4
    f0 = prob.objective_np(np.zeros(prob.partition.n_flat))
    assert float(r4.objective) <= 1e-9 * f0
    np.testing.assert_allclose(float(r4.objective), float(r0.objective),
                               rtol=0.5, atol=1e-3)


def test_interleave_stacked_rows_layout():
    """Each shard's segment of the interleaved RHS must be its locally
    stacked [b_top_k; b_bot_k] (zero-padded parts), for any nr — including
    p < nr (padded eq rows)."""
    from bsls_tpu.parallel.sharding import interleave_stacked_rows

    rng = np.random.default_rng(0)
    for nr, m, p, S in [(8, 60, 4, 1), (4, 64, 10, 3), (2, 7, 1, 2)]:
        bt, bb = rng.standard_normal((S, m)), rng.standard_normal((S, p))
        out = interleave_stacked_rows(bt, bb, nr)
        ml, pl = -((-m) // nr), -((-p) // nr)
        assert out.shape == (S, nr * (ml + pl))
        btp = np.concatenate([bt, np.zeros((S, nr * ml - m))], axis=1)
        bbp = np.concatenate([bb, np.zeros((S, nr * pl - p))], axis=1)
        seg = out.reshape(S, nr, ml + pl)
        np.testing.assert_array_equal(seg[:, :, :ml].reshape(S, -1), btp)
        np.testing.assert_array_equal(seg[:, :, ml:].reshape(S, -1), bbp)


def test_row_sharded_equality_constrained(eight_devices):
    """Row-sharded eq (round 4, last sharding guard lifted): BOTH parts of
    the stacked [A; sqrt(rho) C] shard their rows over the block axis
    (device k owns the locally stacked [A_k; sr*C_k]; b interleaves to
    match, the A^T r partials psum).  Must match the unsharded AL solve,
    including when p < n_devices (padded eq rows)."""
    mesh = make_mesh(block=8, scenario=1, devices=eight_devices)
    prob = synthetic.traffic_like(seed=0, num_blocks=12, m=60, num_eq=4)
    kw = dict(method="apgd", tol=1e-7, max_iter=2000, chunk=100)
    r_rows = solve_sharded(prob, mesh, shard_rows=True, **kw)
    r_ref = bsls.solve(prob, **kw)
    assert r_rows.eq_violation <= max(1e-6, 3.0 * r_ref.eq_violation)
    np.testing.assert_allclose(float(np.asarray(r_rows.objective)),
                               float(np.asarray(r_ref.objective)),
                               rtol=0.25, atol=1e-4)
    # ...and refine runs the host f64 finishing outers on the gathered
    # iterate, same as the column-sharded mesh path
    r_pol = solve_sharded(prob, mesh, shard_rows=True, refine=2, **kw)
    assert r_pol.eq_violation <= max(1e-6, r_rows.eq_violation * 1.01)


@pytest.mark.slow
def test_row_sharded_eq_multi_rhs(eight_devices):
    """Row-sharded eq over a (block=4, scenario=2) mesh with (S, m) b."""
    mesh = make_mesh(block=4, scenario=2, devices=eight_devices)
    prob = synthetic.traffic_like(seed=1, num_blocks=12, m=64, num_eq=4)
    b2 = np.stack([np.asarray(prob.b), np.asarray(prob.b) * 1.02])
    d2 = np.stack([np.asarray(prob.d)] * 2)
    p2 = bsls.Problem(A=prob.A, b=b2, partition=prob.partition,
                      C=prob.C, d=d2)
    kw = dict(method="apgd", tol=1e-7, max_iter=2000, chunk=100)
    r_rows = solve_sharded(p2, mesh, shard_rows=True, **kw)
    r_ref = bsls.solve(p2, **kw)
    assert r_rows.eq_violation <= max(1e-4, 3.0 * r_ref.eq_violation)
    np.testing.assert_allclose(np.asarray(r_rows.objective),
                               np.asarray(r_ref.objective),
                               rtol=0.25, atol=2e-3)


@pytest.mark.slow
def test_sharded_eq_checkpoint_metrics_resume(eight_devices, tmp_path):
    """Sharded eq solves carry checkpoint/metrics/resume: the AL loop checkpoints (lam, x, rho) at outer granularity,
    logs one 'outer' record per outer, and a resumed run converges to the
    same optimum."""
    import json

    from bsls_tpu.models.synthetic import with_scenarios
    from bsls_tpu.utils.metrics import MetricsWriter

    mesh = make_mesh(block=4, scenario=2, devices=eight_devices)
    prob = synthetic.traffic_like(seed=3, num_blocks=48, m=200, num_eq=8,
                                  noise=1e-3)
    p4 = with_scenarios(prob, 4, seed=9, noise=1e-3)
    ck = str(tmp_path / "eq.npz")
    mp = str(tmp_path / "m.jsonl")
    with MetricsWriter(mp) as mw:
        r_full = solve_sharded(p4, mesh, method="apgd", tol=1e-7,
                               max_iter=3000, chunk=100, metrics=mw,
                               checkpoint_path=ck, checkpoint_every=1)
    recs = [json.loads(ln) for ln in open(mp)]
    outers = [x for x in recs if x["kind"] == "outer"]
    assert outers and all("viol" in x and "rho" in x for x in outers)
    assert any(x["kind"] == "chunk" for x in recs)  # inner telemetry too
    r_res = solve_sharded(p4, mesh, method="apgd", tol=1e-7, max_iter=3000,
                          chunk=100, checkpoint_path=ck, resume=True)
    assert r_res.eq_violation <= 1e-6
    # atol: converged objectives sit at the fp32 noise floor (~1e-8)
    np.testing.assert_allclose(np.asarray(r_res.objective),
                               np.asarray(r_full.objective), rtol=1e-4,
                               atol=1e-7)


@pytest.mark.slow
def test_2d_grid_sharded_ell(eight_devices):
    """Full 2-D sharded matvec (SURVEY §2b): (row=2, block=2, scenario=2)
    mesh; A@x psums over 'block', A^T r psums over 'row'."""
    mesh = make_mesh(row=2, block=2, scenario=2, devices=eight_devices)
    prob = synthetic.medium_sparse(seed=12, num_blocks=160, m=1600)
    from bsls_tpu.models.synthetic import with_scenarios

    p4 = with_scenarios(prob, 4, seed=2)
    r2d = solve_sharded(p4, mesh, method="pgd", tol=0.0, max_iter=300)
    r1d = bsls.solve(p4, method="pgd", tol=0.0, max_iter=300)
    np.testing.assert_allclose(
        np.asarray(r2d.objective), np.asarray(r1d.objective), rtol=5e-4
    )


def test_2d_grid_sharded_dense(eight_devices):
    mesh = make_mesh(row=2, block=4, scenario=1, devices=eight_devices)
    prob = synthetic.tiny_dense(seed=13, num_blocks=32, dim=4, m=203)  # pad path
    r2d = solve_sharded(prob, mesh, method="apgd", tol=0.0, max_iter=300)
    r1d = bsls.solve(prob, method="apgd", tol=0.0, max_iter=300)
    np.testing.assert_allclose(
        float(np.asarray(r2d.objective)), float(np.asarray(r1d.objective)),
        rtol=5e-4, atol=1e-6,
    )


# ---------------- sharded banded layout ----------------
#
# Corridor-structured instances are where the banded-split layout pays
# single-RHS; these tests pin that layout's block-mesh form: band tensors sharded along
# the group (ladder-page) axis — contiguous block ranges in the
# value-grouped partition — with the same length-m psum as the gather
# layout.


def test_sharded_banded_auto_selected(eight_devices):
    """layout='auto' at S<16 picks the banded layout under a block mesh and
    matches the unsharded solve (which picks the same layout)."""
    from bsls_tpu.models.synthetic import with_scenarios
    from bsls_tpu.ops.banded import DeviceBanded

    mesh = make_mesh(block=4, scenario=2, devices=eight_devices)
    prob = with_scenarios(synthetic.medium_banded(seed=0, num_blocks=600), 2, seed=5)
    dp, part = shard_problem(prob, mesh, layout="auto")
    assert isinstance(dp.A, DeviceBanded)
    assert dp.A.n_shards == 4 and dp.A.pages % 4 == 0
    # band tensors really sharded along the group axis
    assert dp.A.bands[0].sharding.spec[0] == "block"
    res4 = solve_sharded(prob, mesh, method="pgd", line_search="bb",
                         tol=0.0, max_iter=60, chunk=20)
    res1 = bsls.solve(prob, method="pgd", line_search="bb",
                      tol=0.0, max_iter=60, chunk=20)
    np.testing.assert_allclose(
        np.asarray(res4.objective), np.asarray(res1.objective), rtol=5e-4
    )
    np.testing.assert_allclose(res4.x, res1.x, atol=5e-4)


def test_sharded_banded_forced_single_rhs(eight_devices):
    """layout='banded' forces the band path on the full 8-way block mesh;
    single-RHS parity against the unsharded banded solve (ragged buckets:
    medium_banded has 2 width buckets)."""
    from bsls_tpu.ops.banded import DeviceBanded

    mesh = make_mesh(block=8, scenario=1, devices=eight_devices)
    prob = synthetic.medium_banded(seed=3, num_blocks=600)
    dp, part = shard_problem(prob, mesh, layout="banded")
    assert isinstance(dp.A, DeviceBanded) and dp.A.n_shards == 8
    res8 = solve_sharded(prob, mesh, method="lbfgs", tol=1e-7, max_iter=300,
                         chunk=50, layout="banded")
    res1 = bsls.solve(prob, method="lbfgs", tol=1e-7, max_iter=300, chunk=50)
    np.testing.assert_allclose(
        float(np.asarray(res8.objective)), float(np.asarray(res1.objective)),
        rtol=5e-4, atol=1e-5,
    )


def test_sharded_banded_gather_fallback(eight_devices):
    """Uniform-random instances TALLER than the window (column spans exceed
    the 8-page ladder window) fail the bandability pre-screen and fall back
    to the gather layout under layout='auto' on a mesh.  (Short instances —
    m within ~8 pages — are legitimately bandable and take the band path.)"""
    from bsls_tpu.ops.banded import DeviceBanded

    mesh = make_mesh(block=4, scenario=2, devices=eight_devices)
    prob = _uniform_prob(S=2, m=4096)
    dp, part = shard_problem(prob, mesh, layout="auto")
    assert not isinstance(dp.A, DeviceBanded)


def test_sharded_refine_crosses_true_gap(eight_devices):
    """refine=K on a mesh-sharded solve: the gathered
    result is polished by the host float64 CG path (refine_polish with
    dp=None) and must cross the TRUE f64-evaluated 1e-6 relative gap that
    plain fp32 floors above — the config-4 honest-accuracy story."""
    from bsls_tpu.models import oracle_solve

    mesh = make_mesh(block=4, scenario=2, devices=eight_devices)
    prob = _uniform_prob(S=2, num_blocks=64, dim=8, m=256, seed=3)
    singles = [
        bsls.Problem(A=prob.A, b=prob.b[s], partition=prob.partition)
        for s in range(2)
    ]
    orc = [
        oracle_solve(p, tol_gap=1e-11, max_iter=30000).objective
        for p in singles
    ]
    r0 = bsls.solve(prob, method="pgd", line_search="bb", tol=0.0,
                    max_iter=600, chunk=50, mesh=mesh)
    r1 = bsls.solve(prob, method="pgd", line_search="bb", tol=0.0,
                    max_iter=600, chunk=50, mesh=mesh, refine=6)
    f1 = np.asarray(r1.objective, np.float64)
    # the unrefined fp32 iterate's block sums are off by O(1e-7), which can
    # put its raw objective BELOW f*; compare with it made feasible in f64
    # (clip + per-block renormalise, the repair refine_polish starts from)
    sizes = prob.partition.sizes
    starts = np.concatenate([[0], np.cumsum(sizes)])[:-1]
    x0h = np.maximum(np.asarray(r0.x, np.float64), 0.0)
    x0h = x0h / np.repeat(np.add.reduceat(x0h, starts, axis=-1), sizes, axis=-1)
    f0 = np.asarray(
        [float(singles[s].objective_np(x0h[s])) for s in range(2)])
    for s in range(2):
        rel = (f1[s] - orc[s]) / max(1.0, abs(orc[s]))
        assert rel < 1e-6, (s, f1[s], orc[s], rel)
    # never worse than the unrefined sharded solve
    assert np.all(f1 <= f0 + 1e-12), (f1, f0)
    # refined x is feasible
    x = np.asarray(r1.x)
    off = np.concatenate([[0], np.cumsum(prob.partition.sizes)])[:-1]
    assert np.all(x >= -1e-12)
    assert np.allclose(np.add.reduceat(x, off, axis=-1), 1.0, atol=1e-9)
