"""Projection kernel (Pallas, Triton route) in interpret mode on the CPU vs
the numpy references, plus the XLA paths that replaced the PAVA and banded
page kernels."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bsls_tpu.models import synthetic
from bsls_tpu.ops import banded, isotonic
from bsls_tpu.ops import layout as L
from bsls_tpu.ops.pallas.projection_kernel import (
    MAX_KERNEL_WIDTH,
    proj_simplex_kernel,
    proj_simplex_rows,
    tile_shape,
)
from bsls_tpu.ops.projection import proj_blocks, proj_simplex_padded
from bsls_tpu.utils.refimpl import pava_np, proj_simplex_np

RNG = np.random.default_rng(11)


def _check_rows(got, v, widths, radius, rows=None):
    for i in range(v.shape[0]) if rows is None else rows:
        n = widths[i]
        if n:
            want = radius[i] * proj_simplex_np(
                v[i, :n].astype(np.float64) / radius[i])
            np.testing.assert_allclose(got[i, :n], want, atol=3e-5)
        np.testing.assert_allclose(got[i, n:], 0.0)


def _random_rows(B, w):
    v = (RNG.standard_normal((B, w)) * 3).astype(np.float32)
    widths = RNG.integers(1, w + 1, size=B).astype(np.int32)
    radius = RNG.uniform(0.5, 5.0, size=B).astype(np.float32)
    return v, widths, radius


@pytest.mark.parametrize("w", [1, 2, 3, 5, 7, 8, 9, 12, 13, 16])
def test_projection_kernel_matches_reference(w):
    """Every padded width the kernel takes (1 to 16), at widths that pad
    and widths that do not."""
    v, widths, radius = _random_rows(48, w)
    got = np.asarray(proj_simplex_rows(jnp.asarray(v), jnp.asarray(widths),
                                       jnp.asarray(radius), interpret=True))
    _check_rows(got, v, widths, radius)


@pytest.mark.parametrize("w", [5, 16])
def test_projection_kernel_float64(w):
    """Float64 rows (a float64 solve) stay float64 through the kernel and
    match the reference to float64 rounding."""
    v, widths, radius = _random_rows(40, w)
    with jax.enable_x64(True):
        got = proj_simplex_rows(jnp.asarray(v, jnp.float64), jnp.asarray(widths),
                                jnp.asarray(radius, jnp.float64), interpret=True)
        assert got.dtype == jnp.float64
        got = np.asarray(got)
    for i in range(v.shape[0]):
        n = widths[i]
        want = radius[i] * proj_simplex_np(v[i, :n].astype(np.float64) / radius[i])
        np.testing.assert_allclose(got[i, :n], want, atol=1e-12)
        np.testing.assert_allclose(got[i, n:], 0.0)


def test_projection_kernel_spread_values():
    """Widely spread values (support of one slot next to rows of all slots)
    keep the exact threshold: the pairwise search has no iteration count
    to run out."""
    v = np.array([[1e4, -1e4, 0.0, 5.0, -3.0, 2.0, 1e3, -1e3],
                  [1e-3, 2e-3, 3e-3, 4e-3, 5e-3, 6e-3, 7e-3, 8e-3],
                  [-50.0, -40.0, -30.0, -20.0, -10.0, 0.0, 10.0, 20.0]],
                 np.float32)
    widths = np.array([8, 8, 6], np.int32)
    radius = np.array([1.0, 2.0, 100.0], np.float32)
    got = np.asarray(proj_simplex_rows(jnp.asarray(v), jnp.asarray(widths),
                                       jnp.asarray(radius), interpret=True))
    _check_rows(got, v, widths, radius)


def test_projection_kernel_dummy_rows():
    v = RNG.standard_normal((16, 4)).astype(np.float32)
    widths = np.array([4] * 8 + [0] * 8, np.int32)
    radius = np.ones(16, np.float32)
    got = np.asarray(proj_simplex_rows(jnp.asarray(v), jnp.asarray(widths),
                                       jnp.asarray(radius), interpret=True))
    np.testing.assert_allclose(got[8:], 0.0)
    np.testing.assert_allclose(got[:8].sum(-1), 1.0, rtol=1e-5)


def test_projection_kernel_ties():
    """Tied values (a common case at a feasible start) give the exact
    threshold: every tie shares the count of the whole tie group."""
    v = np.array([[0.5, 0.5, 0.5, 0.5, -1.0, 0.0],
                  [2.0, 2.0, 1.0, 1.0, 1.0, 0.0]], np.float32)
    widths = np.array([6, 5], np.int32)
    radius = np.array([1.0, 3.0], np.float32)
    got = np.asarray(proj_simplex_rows(jnp.asarray(v), jnp.asarray(widths),
                                       jnp.asarray(radius), interpret=True))
    _check_rows(got, v, widths, radius)


@pytest.mark.parametrize("w", [2, 6, 16, 33])
def test_pava_kernel_matches_reference(w):
    """Bounded isotonic regression (isotonic.pava_bounded, the XLA minimax
    path) vs the numpy PAVA reference."""
    B = 40
    y = (RNG.standard_normal((B, w)) * 2).astype(np.float32)
    widths = RNG.integers(1, w + 1, size=B).astype(np.int32)
    radius = RNG.uniform(0.5, 3.0, size=B).astype(np.float32)
    got = np.asarray(isotonic.pava_bounded(jnp.asarray(y), jnp.asarray(widths),
                                           jnp.asarray(radius)))
    for i in range(B):
        n = widths[i]
        want = pava_np(y[i, :n].astype(np.float64), lo=0.0, hi=float(radius[i]))
        np.testing.assert_allclose(got[i, :n], want, atol=3e-5)
        np.testing.assert_allclose(got[i, n:], 0.0)


def _non_tile_multiple(w):
    _, TB = tile_shape(w)
    B = 2 * TB + 5  # last program's rows are partly out of bounds
    v = RNG.standard_normal((B, w)).astype(np.float32)
    widths = np.full(B, w, np.int32)
    radius = np.ones(B, np.float32)
    got = np.asarray(proj_simplex_rows(jnp.asarray(v), jnp.asarray(widths),
                                       jnp.asarray(radius), interpret=True))
    assert got.shape == (B, w)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)
    _check_rows(got, v, widths, radius, rows=range(B - 7, B))


def test_kernels_handle_non_tile_multiple_batch():
    _non_tile_multiple(8)


@pytest.mark.parametrize("w", [3, 12, 16])
def test_kernel_row_padding_other_tiles(w):
    """The partial last program at the other tile shapes."""
    _non_tile_multiple(w)


@pytest.mark.parametrize(
    "w,W", [(1, 1), (2, 2), (3, 4), (5, 8), (8, 8), (12, 16), (16, 16)])
def test_tile_shape_pads_width_to_power_of_two(w, W):
    """Width pads to the next power of two; each (TB, W, W) tile stays
    within the register budget with a power-of-two row count."""
    got_W, TB = tile_shape(w)
    assert got_W == W
    assert TB >= 1 and TB & (TB - 1) == 0
    assert TB * W * W <= 4096 or TB == 1
    assert W <= MAX_KERNEL_WIDTH


def test_kernel_refuses_wider_than_max_width():
    """Wider blocks are the sort path's, never the kernel's."""
    v = jnp.zeros((4, MAX_KERNEL_WIDTH + 1), jnp.float32)
    with pytest.raises(ValueError, match="MAX_KERNEL_WIDTH"):
        proj_simplex_rows(v, jnp.full((4,), 3, jnp.int32), jnp.ones(4),
                          interpret=True)


@pytest.mark.parametrize("w", [2, 5, 8])
def test_transposed_projection_kernel_matches_reference(w):
    """Scenario-batched form: a vmapped (S, B, w) operand folds into S*B
    kernel rows by a reshape; row n reads block n % B."""
    S, B = 3, 100
    v = (RNG.standard_normal((S, B, w)) * 3).astype(np.float32)
    widths = RNG.integers(1, w + 1, size=B).astype(np.int32)
    radius = RNG.uniform(0.5, 5.0, size=B).astype(np.float32)
    entry = jax.vmap(lambda x: proj_simplex_rows(
        x, jnp.asarray(widths), jnp.asarray(radius), interpret=True))
    got = np.asarray(entry(jnp.asarray(v)))
    for s in range(S):
        _check_rows(got[s], v[s], widths, radius, rows=range(0, B, 7))


def test_projection_kernel_custom_vmap_folds():
    """proj_simplex_kernel's vmap rule (nested, and with per-scenario block
    parameters) computes what the per-row reference does."""
    S, T, B, w = 2, 3, 20, 6
    v = (RNG.standard_normal((S, T, B, w)) * 2).astype(np.float32)
    widths = RNG.integers(0, w + 1, size=(T, B)).astype(np.int32)
    radius = RNG.uniform(0.5, 2.0, size=(T, B)).astype(np.float32)
    want = np.stack([np.stack([
        np.asarray(proj_simplex_padded(
            jnp.asarray(v[s, t]),
            (np.arange(w) < widths[t][:, None]).astype(np.float32),
            jnp.asarray(radius[t])))
        for t in range(T)]) for s in range(S)])
    import bsls_tpu.ops.pallas.projection_kernel as pk

    def interp(v, widths, radius):  # the kernel entry, interpret mode
        return proj_simplex_rows(v, widths, radius, interpret=True)

    orig = pk.proj_simplex_rows
    pk.proj_simplex_rows = interp
    try:
        f = jax.vmap(jax.vmap(proj_simplex_kernel, in_axes=(0, 0, 0)),
                     in_axes=(0, None, None))
        got = np.asarray(f(jnp.asarray(v), jnp.asarray(widths),
                           jnp.asarray(radius)))
    finally:
        pk.proj_simplex_rows = orig
    np.testing.assert_allclose(got, want, atol=3e-5)


@pytest.mark.parametrize("w", [2, 5, 8, 16])
def test_transposed_pava_kernel_matches_reference(w):
    """Scenario-batched PAVA (vmap over isotonic.pava_bounded)."""
    S, B = 2, 130
    y = (RNG.standard_normal((S, B, w)) * 2).astype(np.float32)
    widths = RNG.integers(1, w + 1, size=B).astype(np.int32)
    radius = RNG.uniform(0.5, 3.0, size=B).astype(np.float32)
    got = np.asarray(jax.vmap(lambda yy: isotonic.pava_bounded(
        yy, jnp.asarray(widths), jnp.asarray(radius)))(jnp.asarray(y)))
    for s in range(S):
        for i in range(0, B, 13):
            n = widths[i]
            want = np.clip(pava_np(y[s, i, :n].astype(np.float64)), 0, radius[i])
            np.testing.assert_allclose(got[s, i, :n], want, atol=3e-5)
            np.testing.assert_allclose(got[s, i, n:], 0.0)


@pytest.mark.parametrize("S", [1, 3])
def test_banded_page_kernels_match_einsum(S):
    """Banded page contractions under a vmapped scenario axis vs the
    explicit batched einsum."""
    rng = np.random.default_rng(7)
    Mp, C, W = 6, 10, 32
    band = jnp.asarray(rng.standard_normal((Mp, C, W)), jnp.float32)
    xg = jnp.asarray(rng.standard_normal((S, Mp, C)), jnp.float32)
    rw = jnp.asarray(rng.standard_normal((S, Mp, W)), jnp.float32)
    hi = jax.lax.Precision.HIGHEST
    z = jax.vmap(banded._zmv, in_axes=(None, 0))(band, xg)
    np.testing.assert_allclose(
        np.asarray(z),
        np.asarray(jnp.einsum("gcw,sgc->sgw", band, xg, precision=hi)), atol=2e-5)
    g = jax.vmap(banded._grmv, in_axes=(None, 0))(band, rw)
    np.testing.assert_allclose(
        np.asarray(g),
        np.asarray(jnp.einsum("gcw,sgw->sgc", band, rw, precision=hi)), atol=2e-5)


def _proj_lowered(dp, platform):
    xp = L.feasible_init(dp)
    f = jax.jit(jax.vmap(lambda p: proj_blocks(p, dp.buckets)))
    xs = tuple(jnp.stack([x, x]) for x in xp)
    return f.trace(xs).lower(lowering_platforms=(platform,)).as_text()


def test_proj_blocks_lowers_kernel_for_cuda_only():
    """The Triton kernel is what a CUDA lowering emits (one launch per bucket
    under a scenario vmap); a CPU lowering carries the sort path and no
    kernel."""
    dp = L.prepare(synthetic.medium_sparse(seed=1, num_blocks=50, m=500))
    cuda = _proj_lowered(dp, "cuda")
    assert cuda.count("xla.gpu.triton") == len(dp.buckets)
    assert "sort" not in cuda
    cpu = _proj_lowered(dp, "cpu")
    assert "triton" not in cpu and "sort" in cpu


def test_proj_blocks_wide_bucket_uses_sort_path():
    """Blocks wider than MAX_KERNEL_WIDTH take the XLA sort path on every
    platform, and the result matches the reference."""
    w = MAX_KERNEL_WIDTH + 6
    rng = np.random.default_rng(3)
    sizes = np.array([w, w - 3, 4, w])
    import scipy.sparse as sp

    from bsls_tpu.models import Problem

    n = int(sizes.sum())
    A = sp.random(40, n, density=0.2, random_state=1, format="csr")
    prob = Problem.from_arrays(A, rng.standard_normal(40), sizes)
    dp = L.prepare(prob)
    wide = [bk for bk in dp.buckets if bk.mask.shape[-1] > MAX_KERNEL_WIDTH]
    assert wide
    cuda = _proj_lowered(dp, "cuda")
    assert cuda.count("xla.gpu.triton") == len(dp.buckets) - len(wide)
    xp = tuple(jnp.asarray(rng.standard_normal(bk.mask.shape), jnp.float32)
               for bk in dp.buckets)
    got = proj_blocks(xp, dp.buckets)
    for x, g, bk in zip(xp, got, dp.buckets):
        _check_rows(np.asarray(g), np.asarray(x), np.asarray(bk.sizes),
                    np.asarray(bk.radius))
