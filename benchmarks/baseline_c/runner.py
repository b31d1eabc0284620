"""Python wrapper for the C baseline: build, serialize instance, run, parse."""
from __future__ import annotations

import json
import os
import subprocess
import struct
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BIN = os.path.join(HERE, "bsls_baseline")


def build(force: bool = False) -> str:
    if force or not os.path.exists(BIN):
        subprocess.run(["make", "-C", HERE], check=True, capture_output=True)
    return BIN


def write_instance(problem, path: str) -> None:
    """Serialize a Problem (single RHS) to the baseline's binary format."""
    A = problem.A.to_scipy() if hasattr(problem.A, "to_scipy") else None
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    b = np.asarray(problem.b, dtype=np.float64)
    if b.ndim == 2:
        b = b[0]
    bs = np.asarray(problem.partition.sizes, dtype=np.int64)
    with open(path, "wb") as f:
        f.write(struct.pack("<4q", A.shape[0], A.shape[1], A.nnz, len(bs)))
        f.write(np.asarray(A.indptr, dtype=np.int64).tobytes())
        f.write(np.asarray(A.indices, dtype=np.int32).tobytes())
        f.write(np.asarray(A.data, dtype=np.float64).tobytes())
        f.write(b.tobytes())
        f.write(bs.tobytes())


def run_baseline(problem, iters: int = 200, instance_path: str | None = None) -> dict:
    """Returns {'iters_per_sec':…, 'objective':…} measured on this machine."""
    build()
    with tempfile.TemporaryDirectory() as tmp:
        path = instance_path or os.path.join(tmp, "instance.bin")
        write_instance(problem, path)
        out = subprocess.run(
            [BIN, path, str(iters)], check=True, capture_output=True, text=True
        )
    return json.loads(out.stdout.strip())
