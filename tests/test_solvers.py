"""Solver convergence tests — the minimum end-to-end slice (SURVEY.md §7).

Cross-solver agreement on the tiny config to <=1e-6 relative objective gap
against the certified float64 oracle.
"""
import numpy as np
import pytest

import bsls_tpu as bsls
from bsls_tpu.models import oracle_solve, synthetic


@pytest.fixture(scope="module")
def tiny():
    prob = synthetic.tiny_dense(seed=0, num_blocks=50, dim=8, m=400)
    orc = oracle_solve(prob, tol_gap=1e-11, max_iter=20000)
    assert orc.gap <= 1e-11
    return prob, orc


def _relgap(f, fstar):
    return (f - fstar) / max(1.0, abs(fstar))


# FW converges O(1/k) and EG similarly sublinearly on a general QP — their
# per-test targets are set to the algorithmically reachable gap; the PGD
# family must hit the full 1e-6 parity bar.
@pytest.mark.parametrize(
    "method,ls,target",
    [
        ("pgd", "exact", 1e-6),
        ("pgd", "bb", 1e-6),
        ("pgd", "pava", 1e-6),
        ("apgd", "exact", 1e-6),
        ("eg", "exact", 1e-4),
        ("frank_wolfe", "exact", 1e-3),
        ("afw", "exact", 1e-6),  # pairwise FW: linear rate restores parity
        ("lbfgs", "exact", 1e-6),
    ],
)
def test_solver_reaches_oracle_tiny(tiny, method, ls, target):
    prob, orc = tiny
    res = bsls.solve(prob, method=method, line_search=ls, tol=1e-8, max_iter=6000, chunk=200)
    rel = _relgap(float(np.asarray(res.objective)), orc.objective)
    assert rel <= target, f"{method}/{ls}: f={res.objective} f*={orc.objective} rel={rel}"
    # feasibility
    x = np.asarray(res.x, np.float64)
    off = 0
    for n in prob.partition.sizes:
        assert abs(x[off : off + n].sum() - 1) < 1e-4
        assert (x[off : off + n] >= -1e-6).all()
        off += n


def test_pgd_monotone_with_exact_ls(tiny):
    prob, _ = tiny
    res = bsls.solve(prob, method="pgd", line_search="exact", tol=0.0, max_iter=300, chunk=100)
    tf = res.trace_f
    assert (np.diff(tf) <= 1e-5 * np.maximum(1, np.abs(tf[:-1]))).all()


def test_fw_gap_certifies(tiny):
    prob, orc = tiny
    res = bsls.solve(prob, method="frank_wolfe", tol=1e-8, max_iter=6000, chunk=300)
    # FW gap is a certificate: f - f* <= gap at the last iterate
    assert float(res.objective) - orc.objective <= float(res.gap) + 1e-6
    assert _relgap(float(res.objective), orc.objective) <= 2e-3


def test_eg_iterates_stay_positive_and_normalised(tiny):
    prob, _ = tiny
    res = bsls.solve(prob, method="eg", tol=1e-7, max_iter=500, chunk=100)
    x = np.asarray(res.x, np.float64)
    off = 0
    for n in prob.partition.sizes:
        b = x[off : off + n]
        assert abs(b.sum() - 1) < 1e-4 and (b >= 0).all()
        off += n


@pytest.mark.slow
def test_ragged_blocks_solve():
    prob = synthetic.traffic_like(num_blocks=60, m=300, num_eq=0, noise=1e-3)
    prob = bsls.Problem(A=prob.A, b=prob.b, partition=prob.partition, name="ragged")
    orc = oracle_solve(prob, tol_gap=1e-8, max_iter=30000)
    res = bsls.solve(prob, method="apgd", tol=1e-9, max_iter=8000, chunk=250)
    assert _relgap(float(res.objective), orc.objective) <= 1e-5


def test_multi_rhs_vmapped_solve():
    prob = synthetic.large_sharded(num_blocks=32, dim=4, m=64, num_scenarios=3, noise=1e-3)
    res = bsls.solve(prob, method="apgd", tol=1e-8, max_iter=3000, chunk=100)
    assert res.x.shape == (3, prob.partition.n_flat)
    assert np.asarray(res.objective).shape == (3,)
    # each scenario's solution close to its own oracle
    for s in range(3):
        single = bsls.Problem(A=prob.A, b=prob.b[s], partition=prob.partition)
        orc = oracle_solve(single, tol_gap=1e-9, max_iter=10000)
        assert _relgap(float(np.asarray(res.objective)[s]), orc.objective) <= 1e-5


def test_equality_constrained_solve():
    prob = synthetic.traffic_like(num_blocks=40, m=200, num_eq=10, noise=0.0)
    res = bsls.solve(prob, method="apgd", tol=1e-7, max_iter=4000, chunk=200)
    assert res.eq_violation is not None and res.eq_violation <= 1e-4
    # planted x_true satisfies Cx=d and gives objective 0 (noise=0), so the
    # constrained optimum is 0; the reachable floor in fp32 on this
    # demand-scaled instance (b entries ~1e2-1e3) is ~2e-4 — verified
    # empirically that 60k iterations do not go below it.  Bound relative to
    # the trivial objective f(0)=||b||^2/2 instead.
    f0 = prob.objective_np(np.zeros(prob.partition.n_flat))
    assert float(res.objective) <= 1e-9 * f0


def test_equality_constrained_max_iter_budget():
    """max_iter caps the TOTAL inner iterations across AL outers (it was
    silently ignored on the eq path before round 4)."""
    prob = synthetic.traffic_like(num_blocks=40, m=200, num_eq=10, noise=0.0)
    res = bsls.solve(prob, method="apgd", tol=1e-7, max_iter=150, chunk=50)
    assert res.iterations <= 150
    # a budget-limited, unconverged eq solve says WHY it stopped
    if not res.converged:
        assert res.stop_reason == "budget_exhausted"
    # an unbudgeted control run uses more than the budget (so the cap bound)
    res_full = bsls.solve(prob, method="apgd", tol=1e-7, max_iter=4000,
                          chunk=200)
    assert res_full.iterations > 150


def test_equality_constrained_resume_exhausted_budget(tmp_path):
    """Resuming an eq solve whose checkpointed total_iters already meets
    max_iter must return the checkpointed state (stop_reason
    "budget_exhausted"), not crash with result=None (ADVICE r4 medium)."""
    prob = synthetic.traffic_like(num_blocks=40, m=200, num_eq=10, noise=0.0)
    ck = str(tmp_path / "eq_ck")
    first = bsls.solve(prob, method="apgd", tol=1e-7, max_iter=120, chunk=40,
                       checkpoint_path=ck, checkpoint_every=1)
    assert first.iterations >= 120  # budget binds on this instance
    resumed = bsls.solve(prob, method="apgd", tol=1e-7, max_iter=120,
                         chunk=40, checkpoint_path=ck, checkpoint_every=1,
                         resume=True)
    assert resumed.stop_reason == "budget_exhausted"
    assert not resumed.converged
    assert resumed.x.shape == first.x.shape
    # the checkpointed iterate (not zeros) comes back
    np.testing.assert_allclose(np.asarray(resumed.x, np.float64),
                               np.asarray(first.x, np.float64),
                               rtol=1e-5, atol=1e-6)
    # raising the budget lets the resumed solve continue past the checkpoint
    cont = bsls.solve(prob, method="apgd", tol=1e-7, max_iter=4000, chunk=200,
                      checkpoint_path=ck, checkpoint_every=1, resume=True)
    assert float(cont.objective) <= float(first.objective) + 1e-8


def test_afw_beats_plain_fw(tiny):
    """Away/pairwise steps must fix plain FW's sublinear zig-zag (the first
    solver sweep had FW 4 orders of magnitude behind the field)."""
    prob, orc = tiny
    r_fw = bsls.solve(prob, method="frank_wolfe", tol=0.0, max_iter=600, chunk=100)
    r_afw = bsls.solve(prob, method="afw", tol=0.0, max_iter=600, chunk=100)
    gap_fw = _relgap(float(r_fw.objective), orc.objective)
    gap_afw = _relgap(float(r_afw.objective), orc.objective)
    assert gap_afw < 0.1 * gap_fw, (gap_afw, gap_fw)
    # the FW duality gap remains a certificate under pairwise steps
    assert float(r_afw.objective) - orc.objective <= float(r_afw.gap) + 1e-6


def test_stall_stop_rule_terminates(tiny):
    """solve(tol=...) must terminate by criterion, not max_iter, even where
    the FW-gap certificate is loose."""
    prob, orc = tiny
    res = bsls.solve(prob, method="pgd", tol=1e-9, max_iter=50000, chunk=200)
    assert res.converged and res.iterations < 50000
    assert res.stop_reason in ("gap", "stall", "gap/stall")
    # the stall point is a genuine solution
    assert _relgap(float(res.objective), orc.objective) <= 1e-5
    # certificate-only mode is still available
    res_gap = bsls.solve(prob, method="pgd", tol=1e-9, max_iter=600, chunk=200,
                         stop_rule="gap")
    assert res_gap.stop_reason in ("gap", "max_iter")


def test_apgd_rejects_unsupported_line_search(tiny):
    prob, _ = tiny
    with pytest.raises(ValueError, match="apgd"):
        bsls.solve(prob, method="apgd", line_search="bb", max_iter=10)


def test_lbfgs_rejects_unsupported_options(tiny):
    prob, _ = tiny
    with pytest.raises(ValueError, match="lbfgs"):
        bsls.solve(prob, method="lbfgs", line_search="bb", max_iter=10)
    with pytest.raises(ValueError, match="lbfgs"):
        bsls.solve(prob, method="lbfgs", step_size=0.5, max_iter=10)


@pytest.mark.slow
def test_lbfgs_mem_forwarded_everywhere(monkeypatch):
    """lbfgs_mem must reach the inner SolveOptions on all three dispatch
    paths (plain, mesh-sharded, equality-constrained) — it was silently
    dropped to the default on the mesh and eq paths once."""
    import jax

    from bsls_tpu.models import synthetic
    from bsls_tpu.parallel import make_mesh
    from bsls_tpu.solvers import lbfgs as lbfgs_mod

    seen = []
    real_init = lbfgs_mod.init

    def spy_init(dp, L_est, opts, xp0=None):
        seen.append(opts.lbfgs_mem)
        return real_init(dp, L_est, opts, xp0=xp0)

    monkeypatch.setattr(lbfgs_mod, "init", spy_init)
    prob = synthetic.tiny_dense(seed=0, num_blocks=16, dim=4, m=64)
    bsls.solve(prob, method="lbfgs", lbfgs_mem=2, tol=0.0, max_iter=5)
    mesh = make_mesh(block=len(jax.devices()), scenario=1)
    bsls.solve(prob, method="lbfgs", lbfgs_mem=2, mesh=mesh, tol=0.0,
               max_iter=5)
    eq = synthetic.traffic_like(seed=1, num_blocks=12, m=40, num_eq=4,
                                noise=1e-3)
    bsls.solve(eq, method="lbfgs", lbfgs_mem=2, tol=1e-4, max_iter=200)
    assert seen and all(m == 2 for m in seen), seen


def test_lbfgs_zspace_reaches_oracle(tiny):
    """The z-space variant (bounded-isotonic projection of the quasi-Newton
    arc, SURVEY.md §1a 'L-BFGS-in-z-space') matches the oracle too."""
    prob, orc = tiny
    res = bsls.solve(prob, method="lbfgs", space="z", tol=1e-8,
                     max_iter=6000, chunk=200)
    assert _relgap(float(res.objective), orc.objective) <= 1e-6


def test_lbfgs_monotone_and_fast(tiny):
    """Exact line search along the safeguarded arc makes every step a
    descent step, and the curvature memory must beat plain PGD's iteration
    count to the same gap on the same instance."""
    prob, orc = tiny
    r_lb = bsls.solve(prob, method="lbfgs", tol=0.0, max_iter=400, chunk=100,
                      stop_rule="gap")
    tf = np.asarray(r_lb.trace_f)
    assert (np.diff(tf) <= 1e-5 * np.maximum(1, np.abs(tf[:-1]))).all()
    r_pgd = bsls.solve(prob, method="pgd", line_search="exact", tol=0.0,
                       max_iter=400, chunk=100, stop_rule="gap")
    thresh = orc.objective + 1e-6 * max(1.0, abs(orc.objective))
    hit_lb = np.nonzero(tf <= thresh)[0]
    hit_pgd = np.nonzero(np.asarray(r_pgd.trace_f) <= thresh)[0]
    it_lb = int(hit_lb[0]) if hit_lb.size else 10**9
    it_pgd = int(hit_pgd[0]) if hit_pgd.size else 10**9
    assert it_lb < it_pgd, (it_lb, it_pgd)


@pytest.mark.slow
def test_lbfgs_multi_rhs_oracle_parity():
    """Scenario-vmapped lbfgs: per-scenario solves match per-scenario
    single solves (the compact-form Gram machinery under vmap)."""
    base = synthetic.tiny_dense(seed=7, num_blocks=30, dim=6, m=200)
    prob = synthetic.with_scenarios(base, 3, seed=8)
    res = bsls.solve(prob, method="lbfgs", tol=1e-8, max_iter=3000, chunk=100)
    from dataclasses import replace

    for s in range(3):
        r1 = bsls.solve(replace(base, b=np.asarray(prob.b)[s]),
                        method="lbfgs", tol=1e-8, max_iter=3000, chunk=100)
        np.testing.assert_allclose(
            float(np.asarray(res.objective)[s]), float(r1.objective),
            rtol=1e-5, atol=1e-8)


def test_equality_constrained_sparse_C():
    """AL loop with a SPARSE (EllMatrix) constraint matrix — the VStack
    operator must not densify C."""
    import scipy.sparse as sp
    from bsls_tpu.models.problem import EllMatrix, Problem

    base = synthetic.traffic_like(num_blocks=30, m=150, num_eq=0, noise=0.0)
    n = base.A.shape[1]
    rng = np.random.default_rng(3)
    C_sp = sp.random(6, n, density=0.15, random_state=rng, format="csr")
    x_feas = synthetic.random_block_x(rng, base.partition.sizes)
    d = C_sp @ x_feas
    b = base.A.matvec(x_feas)
    prob = Problem.from_arrays(base.A, b, base.partition.sizes, C=C_sp, d=d)
    assert isinstance(prob.C, EllMatrix)
    res = bsls.solve(prob, method="lbfgs", tol=1e-7, max_iter=4000, chunk=200)
    assert res.eq_violation <= 1e-4
    assert float(res.objective) <= 1e-6  # noiseless planted x => f* = 0 (fp32 floor)


def test_lbfgs_compact_matches_two_loop(tiny):
    """The compact (BNS) inverse-Hessian product — the production path —
    must agree with the classic two-loop recursion on a live trajectory,
    including the not-yet-full and rejected-slot cases."""
    import jax.numpy as jnp

    from bsls_tpu.ops import layout as L, quadratic as Q
    from bsls_tpu.solvers import lbfgs as lb
    from bsls_tpu.solvers.base import SolveOptions, power_lipschitz

    prob, _ = tiny
    dp = L.prepare(prob)
    opts = SolveOptions(method="lbfgs", lbfgs_mem=5)
    L_est = power_lipschitz(dp)
    st = lb.init(dp, L_est, opts)
    for i in range(12):  # spans empty -> partial -> full -> wrapped memory
        st = lb.step(dp, st, L_est, opts)
        g = Q.grad_flat(dp, st.r)
        qc = lb.compact_hg(dp, g, st)
        qt = lb.two_loop_hg(dp, g, st)
        rel = float(jnp.linalg.norm(qc - qt) / (1e-30 + jnp.linalg.norm(qt)))
        assert rel < 5e-4, (i, rel)


def test_lbfgs_tiny_memory_ring_buffer(tiny):
    """lbfgs_mem=1 exercises the ring-buffer wraparound every iteration and
    must still converge (degenerates to a scaled-gradient arc)."""
    prob, orc = tiny
    res = bsls.solve(prob, method="lbfgs", lbfgs_mem=1, tol=1e-8,
                     max_iter=6000, chunk=200)
    assert _relgap(float(res.objective), orc.objective) <= 1e-6


@pytest.mark.slow
def test_equality_constrained_multi_rhs():
    """Per-scenario multipliers: (S, m) b against shared C with per-scenario
    targets d (S, p)."""
    from dataclasses import replace

    prob = synthetic.traffic_like(num_blocks=40, m=200, num_eq=8, noise=0.0)
    rng = np.random.default_rng(5)
    sizes = prob.partition.sizes
    xs = np.stack([synthetic.random_block_x(rng, sizes) for _ in range(3)])
    b = np.stack([prob.A.matvec(xs[s]) for s in range(3)])
    d = np.stack([np.asarray(prob.C.matvec(xs[s])) for s in range(3)])
    p3 = replace(prob, b=b, d=d, x_true=xs)
    res = bsls.solve(p3, method="apgd", tol=1e-7, max_iter=4000, chunk=200)
    assert res.x.shape == (3, prob.partition.n_flat)
    assert res.eq_violation is not None and res.eq_violation <= 1e-4
    f0 = p3.objective_np(np.zeros((3, prob.partition.n_flat)))
    assert np.all(np.asarray(res.objective) <= 1e-9 * np.maximum(f0, 1.0))


def test_time_to_gap_metric(tiny):
    prob, orc = tiny
    res = bsls.solve(prob, method="pgd", tol=1e-7, max_iter=4000, chunk=200)
    t = res.time_to_gap(orc.objective, rel=1e-6)
    assert t is not None and t >= 0.0


@pytest.mark.slow
def test_certify_polish_tightens_gap():
    """certify=K runs a pairwise-FW polish that tightens the duality-gap
    certificate by orders of magnitude at equal-or-better objective (on the
    ill-conditioned demand-scaled instances where the raw gap is loose)."""
    prob = synthetic.medium_sparse(seed=0, num_blocks=400, m=3000)
    orc = oracle_solve(prob, tol_gap=1e-9, max_iter=30000)
    r0 = bsls.solve(prob, method="pgd", line_search="bbm", tol=1e-8, max_iter=2000)
    r1 = bsls.solve(prob, method="pgd", line_search="bbm", tol=1e-8, max_iter=2000,
                    certify=150)
    assert float(r1.gap) < 0.1 * float(r0.gap), (r1.gap, r0.gap)
    assert float(r1.objective) <= float(r0.objective) + 1e-6
    # the certificate is sound: f - f* <= gap
    assert float(r1.objective) - orc.objective <= float(r1.gap) + 1e-6


@pytest.mark.slow
def test_refine_polish_breaks_fp32_floor():
    """refine=K (active-set tangent-space CG polish, f64 host anchor) must
    push the true f64-evaluated relative gap well below the fp32 plateau
    (~2e-6..1e-5 on medium-scale instances).  The polish accepts only
    f64-objective improvements, so it can never make the solve worse."""
    prob = synthetic.medium_sparse(seed=0, num_blocks=400, m=3000)
    orc = oracle_solve(prob, tol_gap=1e-10, max_iter=40000)
    r0 = bsls.solve(prob, method="lbfgs", tol=0.0, max_iter=1200, chunk=100)
    f0 = float(prob.objective_np(np.asarray(r0.x, np.float64)))
    r1 = bsls.solve(prob, method="lbfgs", tol=0.0, max_iter=1200, chunk=100,
                    refine=3)
    f1 = float(r1.objective)
    fs = orc.objective
    assert f1 <= f0 + 1e-12  # never worse
    # refined solution is far below the fp32 floor (and feasible)
    assert (f1 - fs) / max(fs, 1e-30) < 1e-7, (f1, f0, fs)
    x = np.asarray(r1.x)
    sizes = prob.partition.sizes
    off = np.concatenate([[0], np.cumsum(sizes)])[:-1]
    assert np.all(x >= -1e-12)
    assert np.allclose(np.add.reduceat(x, off), 1.0, atol=1e-9)


def test_refine_polish_multi_rhs():
    """Multi-RHS refine: each scenario gets its own anchor/active set/step;
    every refined objective is <= the plain one and near its own optimum."""
    prob = synthetic.with_scenarios(synthetic.tiny_dense(num_blocks=20, m=100), 3)
    r0 = bsls.solve(prob, method="lbfgs", tol=0.0, max_iter=400)
    f0 = prob.objective_np(np.asarray(r0.x, np.float64))
    r1 = bsls.solve(prob, method="lbfgs", tol=0.0, max_iter=400, refine=6)
    f1 = np.asarray(r1.objective)
    assert f1.shape == (3,)
    assert np.all(f1 <= f0 + 1e-12)
    # per-scenario f64 oracles pin each optimum
    for s in range(3):
        single = bsls.Problem(A=prob.A, b=prob.b[s], partition=prob.partition)
        fs = oracle_solve(single, tol_gap=1e-11, max_iter=30000).objective
        assert (f1[s] - fs) / max(fs, 1e-30) < 1e-6, (s, f1[s], fs)


def test_refine_polish_eq_constrained():
    """refine=K on an eq-constrained solve runs float64 AL finishing outers
    (polish the stacked subproblem, update multipliers in f64): both the
    true objective gap and the violation must land far below fp32."""
    from bsls_tpu.models.oracle import oracle_solve_eq

    prob = synthetic.traffic_like(seed=0, num_blocks=40, m=300, num_eq=12)
    orc = oracle_solve_eq(prob, tol_eq=1e-10, tol_gap=1e-11)
    r0 = bsls.solve(prob, method="lbfgs", tol=1e-8, max_iter=4000)
    r1 = bsls.solve(prob, method="lbfgs", tol=1e-8, max_iter=4000, refine=6)
    f0 = float(prob.objective_np(np.asarray(r0.x, np.float64)))
    f1 = float(r1.objective)
    ref = max(1.0, abs(orc.objective))
    assert (f1 - orc.objective) / ref < 1e-8, (f1, f0, orc.objective)
    assert r1.eq_violation <= max(1e-9, 0.1 * r0.eq_violation), (
        r1.eq_violation, r0.eq_violation)


def test_refine_tol_certificate_is_sound():
    """refine_tol: the f64 FW duality-gap certificate on the result must
    BOUND the true gap vs the deep oracle (f - f* <= cert).  On
    ill-conditioned instances the certificate is loose (it can stall
    orders above the true gap), so the polish may run to
    the rounds cap; soundness, not tightness, is the contract."""
    prob = synthetic.medium_sparse(seed=0, num_blocks=400, m=3000)
    orc = oracle_solve(prob, tol_gap=1e-10, max_iter=40000)
    res = bsls.solve(prob, method="lbfgs", tol=0.0, max_iter=1200, chunk=100,
                     refine=8, refine_tol=1e-6)
    assert res.refine_fw_gap is not None
    true_rel = (float(res.objective) - orc.objective) / max(
        1.0, abs(orc.objective))
    assert true_rel <= res.refine_fw_gap + 1e-12  # certificate is sound


def test_refine_tol_alone_defaults_round_cap():
    """refine_tol without refine must still run the certified polish
    (default 16-round cap) instead of silently returning the fp32 result
    with refine_fw_gap=None (round-4 fix: the eq surface already treated
    refine_tol as standalone; the unconstrained surface now agrees)."""
    prob = synthetic.tiny_dense(seed=1, num_blocks=20, dim=6, m=150)
    res = bsls.solve(prob, method="pgd", line_search="bb", max_iter=400,
                     refine_tol=1e-7)
    assert res.refine_fw_gap is not None and res.refine_fw_gap <= 1e-7


def test_refine_tol_stops_early_when_certified():
    """On a well-conditioned instance the certificate tightens with the
    iterate, so a generous target stops the polish before the rounds cap
    (observable via iterations: each executed round adds cg_iters)."""
    prob = synthetic.tiny_dense(seed=1, num_blocks=20, dim=6, m=150)
    base = bsls.solve(prob, method="lbfgs", tol=0.0, max_iter=400)
    res = bsls.solve(prob, method="lbfgs", tol=0.0, max_iter=400,
                     refine=20, refine_tol=1e-7)
    # certified mode runs >= 200 CG iterations per executed round
    rounds_run = (res.iterations - base.iterations) / 200
    assert res.refine_fw_gap is not None and res.refine_fw_gap <= 1e-7
    assert rounds_run < 20, rounds_run


def test_refine_polish_rejects_unsupported():
    import jax

    from bsls_tpu.parallel import make_mesh

    from bsls_tpu.parallel import shard_problem

    prob = synthetic.tiny_dense(num_blocks=16, m=80)
    mesh = make_mesh(block=len(jax.devices()))
    # refine on a mesh-sharded solve is supported from a host Problem (the
    # polish gathers and anchors in f64); a pre-sharded triple has no host
    # Problem to anchor against and must be rejected loudly
    dp, part = shard_problem(synthetic.with_scenarios(prob, 1), mesh)
    with pytest.raises(ValueError, match="refine"):
        bsls.solve((dp, part, True), method="pgd", max_iter=10, refine=1,
                   mesh=mesh)


def test_steady_iters_per_sec_spans_syncs():
    """steady_iters_per_sec must use iterations-spanned / seconds-spanned
    over the paired (chunk_iters, chunk_times) sync records — one record may
    cover several chunks under the async loop."""
    from bsls_tpu.solvers.base import SolveResult

    r = SolveResult(
        x=np.zeros(3), objective=0.0, gap=0.0, iterations=700, converged=False,
        trace_f=np.zeros(700), trace_gap=np.zeros(700),
        chunk_times=np.array([10.0, 1.0, 2.0]),  # first interval = compile
        chunk_iters=np.array([100, 300, 700]),   # 100, then 200, then 400
    )
    # (700 - 100) iters over (1 + 2) seconds
    assert abs(r.steady_iters_per_sec() - 200.0) < 1e-9
    # degenerate single record falls back to the full span
    r2 = SolveResult(
        x=np.zeros(3), objective=0.0, gap=0.0, iterations=100, converged=False,
        trace_f=np.zeros(100), trace_gap=np.zeros(100),
        chunk_times=np.array([4.0]), chunk_iters=np.array([100]),
    )
    assert abs(r2.steady_iters_per_sec() - 25.0) < 1e-9


def test_pack_chunk_stats_fixed_shape():
    """pack_chunk_stats pads to MAX_SYNC_CHUNKS so the pack program has ONE
    shape per solve (variable-shape eager stacks cost a compile per
    distinct width)."""
    import jax.numpy as jnp

    from bsls_tpu.solvers.base import MAX_SYNC_CHUNKS, pack_chunk_stats

    tf = [jnp.full((5,), float(i)) for i in range(3)]   # 3 chunks of 5 iters
    tg = [jnp.full((5,), 10.0 + i) for i in range(3)]
    out = np.asarray(pack_chunk_stats(tf, tg, 3, jnp.float32))
    assert out.shape == (2, MAX_SYNC_CHUNKS, 1)
    np.testing.assert_allclose(out[0, :3, 0], [0.0, 1.0, 2.0])
    np.testing.assert_allclose(out[1, :3, 0], [10.0, 11.0, 12.0])
    # pad region repeats the last chunk's stats
    np.testing.assert_allclose(out[0, 3:, 0], 2.0)
    # multi-RHS leaves (S, chunk) -> (2, W, S)
    tfm = [jnp.zeros((4, 5)) + i for i in range(2)]
    outm = np.asarray(pack_chunk_stats(tfm, tfm, 2, jnp.float32))
    assert outm.shape == (2, MAX_SYNC_CHUNKS, 4)


def test_eq_refine_tol_certified():
    """refine_tol on an eq-constrained solve: the
    active-set finisher (prox_bpp_polish) walks to the exact f64 KKT point
    and the Lagrangian dual bound certifies it to ~roundoff; the
    certificate ships as refine_fw_gap and is SOUND vs the f64 oracle."""
    import dataclasses

    from bsls_tpu.models.oracle import oracle_solve_eq

    prob = synthetic.traffic_like(seed=2, num_blocks=30, m=150, num_eq=8,
                                  noise=0.1)
    prob = dataclasses.replace(prob, d=np.asarray(prob.d) * 1.04 + 0.02)
    res = bsls.solve(prob, method="lbfgs", tol=1e-8, max_iter=3000,
                     refine_tol=1e-8)
    assert res.refine_fw_gap is not None and res.refine_fw_gap <= 1e-8, (
        res.refine_fw_gap)
    assert res.eq_violation <= 1e-9, res.eq_violation
    orc = oracle_solve_eq(prob, tol_eq=1e-10, tol_gap=1e-11)
    ref = max(1.0, abs(orc.objective))
    true_rel = (float(res.objective) - orc.objective) / ref
    assert true_rel <= res.refine_fw_gap + 1e-10, (true_rel, res.refine_fw_gap)


def test_bpp_sparse_matches_dense():
    """The sparse-KKT face solves (projected PCG, round 5) must reach the
    same clean KKT point as the dense LAPACK path: both certify to ~f64
    roundoff via the Lagrangian dual bound."""
    from bsls_tpu.solvers.eq_constrained import eq_dual_bound, prox_bpp_polish

    prob = synthetic.traffic_like(seed=2, num_blocks=60, m=300, num_eq=15,
                                  noise=1e-3)
    res = bsls.solve(prob, method="apgd", tol=1e-6, max_iter=4000, chunk=200)
    x0 = np.asarray(res.x, np.float64)
    xd, ld, okd = prox_bpp_polish(prob, x0)  # dense (KKT dim < 1500)
    xs, ls_, oks = prox_bpp_polish(prob, x0, dense_kkt=0)  # force sparse
    assert okd and oks
    assert eq_dual_bound(prob, xd, ld) <= 1e-7
    assert eq_dual_bound(prob, xs, ls_) <= 1e-7
    # same objective to f64 cleanliness (iterates may differ along
    # degenerate face directions; the certificate pins both)
    fd = float(prob.objective_np(xd))
    fs = float(prob.objective_np(xs))
    assert abs(fd - fs) <= 1e-7 * max(1.0, abs(fd)), (fd, fs)


def test_eq_multiplier_polish_tightens_bound():
    """Dual-only polish (round 5): at a CLEAN-support iterate whose
    multipliers are stale or missing (the beyond-max_kkt scenario —
    BASELINE r4 recorded an AL dual bound of 459 at a good x), refitting
    lam on the active face recovers a tight sound bound with no change to
    x.  It cannot rescue a noisy-support fp32 iterate (the FW gap itself
    is loose there); callers keep min(AL bound, refit bound) — both
    sound."""
    from bsls_tpu.solvers.eq_constrained import (
        eq_dual_bound, eq_multiplier_polish, prox_bpp_polish)

    prob = synthetic.traffic_like(seed=3, num_blocks=50, m=250, num_eq=12,
                                  noise=1e-2)
    res = bsls.solve(prob, method="apgd", tol=1e-7, max_iter=6000, chunk=200)
    x, lam_clean, ok = prox_bpp_polish(prob, np.asarray(res.x, np.float64))
    assert ok
    bound_clean = eq_dual_bound(prob, x, lam_clean)
    assert bound_clean <= 1e-8  # the KKT-exact multipliers certify
    # stale multipliers at the same x: bound collapses...
    bound_stale = eq_dual_bound(prob, x, np.zeros_like(lam_clean))
    assert bound_stale > 1e3 * max(bound_clean, 1e-14)
    # ...and the face refit recovers it without touching x
    lam_fit = eq_multiplier_polish(prob, x)
    bound_fit = eq_dual_bound(prob, x, lam_fit)
    assert bound_fit <= max(10 * bound_clean, 1e-9), (bound_fit, bound_clean)
    # soundness vs the f64 eq oracle
    from bsls_tpu.models.oracle import oracle_solve_eq

    orc = oracle_solve_eq(prob, tol_eq=1e-10, tol_gap=1e-11)
    true_rel = (float(prob.objective_np(x)) - orc.objective) / max(
        1.0, abs(orc.objective))
    assert true_rel <= bound_fit + 1e-9, (true_rel, bound_fit)


def test_eq_refine_mesh_matches_unsharded():
    """refine=K on a mesh-sharded eq solve (round 4: the guard is lifted —
    the finishing outers run refine_polish's host f64 PCG path on the
    gathered iterate).  Must reach the same feasibility/objective quality
    as the single-device refine."""
    import jax

    from bsls_tpu.parallel import make_mesh

    prob = synthetic.traffic_like(seed=0, num_blocks=12, m=60, num_eq=4)
    mesh = make_mesh(block=len(jax.devices()))
    r0 = bsls.solve(prob, method="pgd", line_search="bb", max_iter=2000,
                    refine=3)
    r1 = bsls.solve(prob, method="pgd", line_search="bb", max_iter=2000,
                    refine=3, mesh=mesh)
    assert r1.eq_violation <= max(1e-9, 3.0 * r0.eq_violation), (
        r1.eq_violation, r0.eq_violation)
    f0, f1 = float(r0.objective), float(r1.objective)
    assert f1 <= f0 + 1e-6 * max(1.0, abs(f0)), (f1, f0)


def test_eq_refine_tol_mesh_certifies():
    """refine_tol on a mesh-sharded eq solve ships the same sound
    certificate as the single-device path (the bound machinery is
    host-side and sees the gathered iterate)."""
    import jax

    from bsls_tpu.parallel import make_mesh

    prob = synthetic.traffic_like(seed=0, num_blocks=12, m=60, num_eq=4)
    mesh = make_mesh(block=len(jax.devices()))
    res = bsls.solve(prob, method="pgd", line_search="bb", max_iter=2000,
                     refine_tol=1e-8, mesh=mesh)
    assert res.refine_fw_gap is not None and res.refine_fw_gap <= 1e-8, (
        res.refine_fw_gap)
    assert res.eq_violation <= 1e-9, res.eq_violation


@pytest.mark.slow
def test_eq_oracle_direct_vs_al():
    """oracle_solve_eq's direct mode (active-set finisher) must match or
    beat the legacy AL path at equal-or-better feasibility, with a dual
    bound that actually certifies (round-4 finding: the AL path can hit
    inner caps on perturbed instances and report useless bounds)."""
    import dataclasses

    from bsls_tpu.models.oracle import oracle_solve_eq

    prob = synthetic.traffic_like(seed=3, num_blocks=30, m=150, num_eq=8,
                                  noise=0.3)
    prob = dataclasses.replace(prob, d=np.asarray(prob.d) * 1.05 + 0.01)
    o_d = oracle_solve_eq(prob, tol_eq=1e-10, tol_gap=1e-11)  # auto: direct
    o_al = oracle_solve_eq(prob, tol_eq=1e-10, tol_gap=1e-11, direct=False)
    ref = max(1.0, abs(o_al.objective))
    assert o_d.objective <= o_al.objective + 1e-8 * ref, (
        o_d.objective, o_al.objective)
    assert o_d.eq_violation <= 1e-10
    assert o_d.gap <= 1e-6 * ref  # the bound certifies, not just exists


def test_refine_host_toggle(monkeypatch):
    """BSLS_REFINE_HOST=1 forces the host f64 PCG path for plain refine=K
    (required at config-4 scale); quality must match the device path's on
    an instance both handle."""
    monkeypatch.setenv("BSLS_REFINE_HOST", "1")
    prob = synthetic.tiny_dense(seed=3)
    res = bsls.solve(prob, method="pgd", line_search="bb", tol=0.0,
                     max_iter=600, refine=3)
    orc = oracle_solve(prob, tol_gap=1e-10, max_iter=20000)
    rel = (float(res.objective) - orc.objective) / max(1.0,
                                                       abs(orc.objective))
    assert rel <= 1e-6, rel
