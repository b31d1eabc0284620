"""Tests for the profiling utilities (cost analysis + roofline summary)."""
import jax.numpy as jnp
import numpy as np
import pytest

from bsls_tpu.models import synthetic
from bsls_tpu.ops import layout as L
from bsls_tpu.utils.profiling import (
    PEAKS,
    cost_analysis,
    device_peaks,
    roofline_summary,
)


def test_cost_analysis_of_matvec():
    prob = synthetic.tiny_dense(num_blocks=8, dim=4, m=64)
    dp = L.prepare(prob)
    x = L.padded_to_flat(dp, L.feasible_init(dp))
    ca = cost_analysis(lambda v: L.matvec(dp.A, v), x)
    assert isinstance(ca, dict)


def test_roofline_summary_fields():
    prob = synthetic.tiny_dense(num_blocks=8, dim=4, m=64)
    dp = L.prepare(prob)
    x = L.padded_to_flat(dp, L.feasible_init(dp))
    r = roofline_summary(lambda v: L.matvec(dp.A, v), x,
                         device_kind="NVIDIA H100 80GB HBM3")
    assert r["bound"] in ("memory", "compute")
    assert r["speed_of_light_s"] >= 0.0
    peaks = PEAKS["NVIDIA H100 80GB HBM3"]
    assert r["t_memory_s"] == r["bytes_accessed"] / peaks["hbm_bytes_per_s"]


def test_roofline_rejects_unknown_device():
    """No default peak: a device missing from the table is an error (the
    CPU backend here is one)."""
    with pytest.raises(ValueError, match="no peak rates"):
        device_peaks("Unlisted Accelerator 9000")
    with pytest.raises(ValueError, match="no peak rates"):
        roofline_summary(lambda v: v * 2.0, jnp.ones(4))
