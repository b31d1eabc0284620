"""Mesh construction: ('row', 'block', 'scenario') axes over the devices.

The 'block' axis shards the block dimension (x, projections, A columns);
the 'scenario' axis shards the multi-RHS batch (BASELINE.json:10); the
optional 'row' axis shards A's rows and the residual (the SP/CP analog —
combined with 'block' this is the 2-D sharded matvec of SURVEY.md §2b:
A@x partials psum over 'block', A^T r partials psum over 'row', each
collective moving only its axis's payload).  On a multi-host pod slice,
call ``init_distributed()`` first so jax sees all processes' devices (ICI
within a slice, DCN across; SURVEY.md §5).
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np

__all__ = ["BLOCK_AXIS", "SCENARIO_AXIS", "ROW_AXIS", "make_mesh", "init_distributed"]

BLOCK_AXIS = "block"
SCENARIO_AXIS = "scenario"
ROW_AXIS = "row"


def make_mesh(
    block: Optional[int] = None,
    scenario: int = 1,
    row: int = 1,
    devices: Optional[Sequence] = None,
) -> jax.sharding.Mesh:
    """Build a ('row', 'block', 'scenario') mesh (the row axis is size 1 —
    and degenerate — unless requested).  ``row * block * scenario`` must
    equal the device count used."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if block is None:
        block = n // (scenario * row)
    if row * block * scenario != n:
        raise ValueError(
            f"row({row}) * block({block}) * scenario({scenario}) != devices({n})"
        )
    arr = np.asarray(devices).reshape(row, block, scenario)
    return jax.sharding.Mesh(arr, (ROW_AXIS, BLOCK_AXIS, SCENARIO_AXIS))


def init_distributed(coordinator_address: Optional[str] = None, **kw) -> None:
    """Multi-host bootstrap (gang-scheduled pod slice).

    Thin wrapper over jax.distributed.initialize; no-op if already
    initialised or single-process.
    """
    try:
        jax.distributed.initialize(coordinator_address=coordinator_address, **kw)
    except (RuntimeError, ValueError):
        pass  # already initialised or single-process environment
