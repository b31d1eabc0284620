"""Profiling hooks: jax.profiler traces + compiled cost analysis.

(SURVEY.md §5 tracing/profiling: per-kernel cost via cost_analysis, traces
via the Perfetto-compatible jax.profiler, and a roofline summary for the
speed-of-light audit in BENCH notes.)
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import jax

__all__ = ["PEAKS", "trace", "cost_analysis", "device_peaks", "roofline_summary"]


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Profile the enclosed block to ``log_dir`` (no-op if None)."""
    if not log_dir:
        yield
        return
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def cost_analysis(fn, *args, **kwargs) -> dict:
    """FLOPs / bytes-accessed estimate of the compiled fn at these args."""
    lowered = jax.jit(fn).lower(*args, **kwargs)
    compiled = lowered.compile()
    ca = compiled.cost_analysis()
    if isinstance(ca, list):  # older jax returns a per-computation list
        ca = ca[0] if ca else {}
    return dict(ca or {})


# Published peaks by ``device_kind`` as JAX reports it.  float32 FLOP/s is
# the rate outside the tensor cores: the solver's products run at
# Precision.HIGHEST, which keeps them off TF32.
# Source: NVIDIA H100 Tensor Core GPU datasheet, SXM5 column (dense rates,
# 700 W power limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"flops_f32": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def device_peaks(device_kind: Optional[str] = None) -> dict:
    """Peak rates of ``device_kind`` (default: the first JAX device).
    A device that is not in PEAKS is an error, not a default."""
    kind = device_kind if device_kind is not None else jax.devices()[0].device_kind
    if kind not in PEAKS:
        raise ValueError(f"no peak rates recorded for device kind {kind!r}; "
                         f"known: {sorted(PEAKS)}")
    return PEAKS[kind]


def roofline_summary(fn, *args, device_kind: Optional[str] = None,
                     **kwargs) -> dict:
    """Compare a step's cost estimate with the device's peaks (PEAKS) to
    bound achievable step time."""
    peaks = device_peaks(device_kind)
    ca = cost_analysis(fn, *args, **kwargs)
    flops = float(ca.get("flops", 0.0))
    bytes_ = float(ca.get("bytes accessed", ca.get("bytes_accessed", 0.0)))
    t_compute = flops / peaks["flops_f32"]
    t_memory = bytes_ / peaks["hbm_bytes_per_s"]
    return {
        "flops": flops,
        "bytes_accessed": bytes_,
        "bound": "memory" if t_memory >= t_compute else "compute",
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "speed_of_light_s": max(t_compute, t_memory),
    }
