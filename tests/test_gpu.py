"""Card-only checks: the compiled Triton projection kernel and the
HIGHEST-precision dense products on an NVIDIA GPU.  They skip elsewhere;
on a card run ``python -m pytest -m gpu tests/``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bsls_tpu.models import synthetic
from bsls_tpu.ops import layout as L
from bsls_tpu.ops.pallas.projection_kernel import proj_simplex_rows
from bsls_tpu.ops.projection import proj_simplex_padded
from bsls_tpu.utils.refimpl import proj_simplex_np

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("w", [3, 8, 12, 16])
def test_compiled_kernel_matches_reference(gpu, w):
    rng = np.random.default_rng(w)
    S, B = 4, 5000
    v = (3 * rng.standard_normal((S, B, w))).astype(np.float32)
    widths = rng.integers(0, w + 1, size=B).astype(np.int32)
    radius = rng.uniform(0.5, 2.0, size=B).astype(np.float32)
    got = np.asarray(proj_simplex_rows(jnp.asarray(v), jnp.asarray(widths),
                                       jnp.asarray(radius)))
    mask = (np.arange(w) < widths[:, None]).astype(np.float32)
    xla = np.asarray(proj_simplex_padded(jnp.asarray(v), jnp.asarray(mask),
                                         jnp.asarray(radius)))
    np.testing.assert_allclose(got, xla, atol=2e-5)
    for s, i in zip(rng.integers(0, S, 300), rng.integers(0, B, 300)):
        n = widths[i]
        if n:
            want = radius[i] * proj_simplex_np(v[s, i, :n].astype(np.float64)
                                               / radius[i])
            np.testing.assert_allclose(got[s, i, :n], want,
                                       atol=1e-5 * radius[i] + 1e-6)
        assert np.all(got[s, i, n:] == 0)


def test_dense_products_keep_float32_precision(gpu):
    """No TF32: batched dense products stay within 1e-6 of float64."""
    dp = L.prepare(synthetic.make_config("tiny"))
    A = np.asarray(dp.A.data, np.float64)
    X = np.abs(np.random.default_rng(0).standard_normal((16, A.shape[1])))
    X = X.astype(np.float32)
    got = np.asarray(jax.vmap(lambda x: L.matvec(dp.A, x))(jnp.asarray(X)))
    want = X.astype(np.float64) @ A.T
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-6
