"""Banded-split layout tests (ops/banded.py): build-time split correctness,
matvec/rmatvec equivalence with the host operator, auto-selection policy,
and end-to-end solve parity."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bsls_tpu as bsls
from bsls_tpu.models import oracle_solve, synthetic
from bsls_tpu.ops import layout as L
from bsls_tpu.ops.banded import DeviceBanded


@pytest.fixture(scope="module")
def banded_prob():
    return synthetic.medium_banded(seed=2, num_blocks=300, m=3000, spread=120)


@pytest.fixture(scope="module")
def banded_dp(banded_prob):
    dp = L.prepare(banded_prob)
    assert isinstance(dp.A, DeviceBanded), "banded layout should auto-select"
    return dp


def test_banded_auto_selection(banded_dp):
    A = banded_dp.A
    # the corridor instance should put nearly all nonzeros in the band
    resid_nnz = 0 if A.resid is None else int((np.asarray(A.resid.vals) != 0).sum())
    assert resid_nnz < 0.4 * 18000


def test_uniform_random_rejects_banded():
    prob = synthetic.medium_sparse(seed=3, num_blocks=200, m=4000)
    dp = L.prepare(prob)
    assert not isinstance(dp.A, DeviceBanded)


def test_banded_matvec_matches_host(banded_prob, banded_dp):
    dp = banded_dp
    rng = np.random.default_rng(0)
    x = rng.random(banded_prob.partition.n_flat)
    xp = L.inject_user_flat(dp, jnp.asarray(x, jnp.float32))
    xf = L.padded_to_flat(dp, xp)
    y = np.asarray(L.matvec(dp.A, xf))
    y_host = banded_prob.A.matvec(x)
    scale = max(1.0, np.abs(y_host).max())
    np.testing.assert_allclose(y / scale, y_host / scale, atol=1e-5)


def test_banded_rmatvec_matches_host(banded_prob, banded_dp):
    dp = banded_dp
    rng = np.random.default_rng(1)
    r = rng.standard_normal(banded_prob.A.shape[0]).astype(np.float32)
    g = np.asarray(L.rmatvec(dp.A, jnp.asarray(r)))
    gn = banded_prob.A.rmatvec(r.astype(np.float64))
    perm = np.asarray(dp.perm)
    sel = perm >= 0
    rad = np.concatenate([
        np.repeat(np.asarray(bk.radius)[:, None], bk.mask.shape[1], 1).reshape(-1)
        for bk in dp.buckets
    ])
    g_user = np.zeros(banded_prob.partition.n_flat)
    g_user[perm[sel]] = g[sel] * rad[sel]
    scale = max(1.0, np.abs(gn).max())
    np.testing.assert_allclose(g_user / scale, gn / scale, atol=1e-5)


@pytest.mark.slow
def test_banded_solve_reaches_oracle(banded_prob):
    res = bsls.solve(banded_prob, method="pgd", line_search="bbm", tol=1e-9,
                     max_iter=8000, chunk=400)
    orc = oracle_solve(banded_prob, tol_gap=1e-10, max_iter=60000)
    rel = (float(res.objective) - orc.objective) / max(1.0, abs(orc.objective))
    assert rel <= 1e-4, (res.objective, orc.objective)
    # solution feasible in user space
    x = np.asarray(res.x, np.float64)
    off = 0
    for n in banded_prob.partition.sizes:
        assert abs(x[off : off + n].sum() - 1) < 1e-4
        assert (x[off : off + n] >= -1e-6).all()
        off += n


def test_banded_multi_rhs(banded_prob):
    p3 = synthetic.with_scenarios(banded_prob, 3, seed=5)
    res = bsls.solve(p3, method="apgd", tol=1e-8, max_iter=1500)
    assert res.x.shape == (3, banded_prob.partition.n_flat)
    assert np.all(np.isfinite(np.asarray(res.objective)))


def test_banded_scenario_crossover_policy(banded_prob):
    """layout="auto" keeps the band for small scenario batches but falls
    back to the gather layout at S>=16 (band-tensor stream bytes don't
    shrink with S while batching amortises the gathers); layout="banded"
    still forces the band."""
    p_small = synthetic.with_scenarios(banded_prob, 4, seed=7)
    assert isinstance(L.prepare(p_small).A, DeviceBanded)
    p_big = synthetic.with_scenarios(banded_prob, 16, seed=7)
    assert not isinstance(L.prepare(p_big).A, DeviceBanded)
    assert isinstance(L.prepare(p_big, layout="banded").A, DeviceBanded)


def test_banded_forced_and_gather_agree(banded_prob):
    """The two layouts are different encodings of the same operator: a
    fixed-iteration solve must agree closely."""
    dpb = L.prepare(banded_prob, layout="banded")
    dpg = L.prepare(banded_prob, layout="gather")
    rb = bsls.solve(dpb, method="pgd", tol=0.0, max_iter=300)
    rg = bsls.solve(dpg, method="pgd", tol=0.0, max_iter=300)
    np.testing.assert_allclose(
        float(rb.objective), float(rg.objective), rtol=5e-4, atol=1e-6
    )


def test_rcm_recovers_bandability():
    """RCM row reordering turns a row-shuffled corridor instance back into
    a banded-selectable one; solutions are unchanged (rows are semantically
    order-free)."""
    from dataclasses import replace

    from bsls_tpu.models.problem import EllMatrix
    from bsls_tpu.models.reorder import estimate_bandability, reorder_rows_rcm

    prob = synthetic.medium_banded(num_blocks=300, m=3000, spread=100, seed=6)
    rng = np.random.default_rng(1)
    perm = rng.permutation(prob.A.shape[0])
    rank = np.empty(perm.size, np.int64)
    rank[perm] = np.arange(perm.size)
    A_shuf = EllMatrix(rows=rank[np.asarray(prob.A.rows)].astype(np.int32),
                       vals=np.asarray(prob.A.vals), num_rows=prob.A.num_rows)
    p_shuf = replace(prob, A=A_shuf, b=np.asarray(prob.b)[perm])
    assert estimate_bandability(p_shuf.A) < 0.2
    assert not isinstance(L.prepare(p_shuf).A, DeviceBanded)

    p_rcm = reorder_rows_rcm(p_shuf)
    assert estimate_bandability(p_rcm.A) > 0.9
    assert isinstance(L.prepare(p_rcm).A, DeviceBanded)
    r1 = bsls.solve(p_shuf, method="pgd", line_search="bbm", tol=0.0, max_iter=300)
    r2 = bsls.solve(p_rcm, method="pgd", line_search="bbm", tol=0.0, max_iter=300)
    # gather vs banded layouts order blocks differently, so 300-iteration BB
    # trajectories agree only approximately (parity at convergence is covered
    # by test_banded_solve_reaches_oracle)
    np.testing.assert_allclose(float(r1.objective), float(r2.objective), rtol=1e-2)
