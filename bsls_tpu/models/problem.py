"""Problem model: matrices, right-hand sides, block structure, constraints.

Host-side (numpy/scipy) representation.  The device-side prepared form
(jnp arrays, index maps, shardings) is built by ``bsls_tpu.ops.layout`` /
``bsls_tpu.parallel``.

Mirrors the reference's instance model — scipy-sparse ``A``, dense ``b``,
``block_sizes`` vector, loaded from .mat files (SURVEY.md §2 #13,
[UNVERIFIED] — reference mount empty) — generalised with multi-RHS scenario
batching and optional linear equality constraints (SURVEY.md §2 #12).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .partition import BlockPartition

__all__ = ["DenseMatrix", "EllMatrix", "VStackMatrix", "ScaledMatrix", "Problem"]


@dataclass(frozen=True)
class DenseMatrix:
    """Dense m x n matrix."""

    data: np.ndarray  # (m, n)

    @property
    def shape(self):
        return self.data.shape

    def matvec(self, x: np.ndarray) -> np.ndarray:
        return self.data @ x

    def rmatvec(self, r: np.ndarray) -> np.ndarray:
        return self.data.T @ r

    def to_scipy(self):
        return self.data


@dataclass(frozen=True)
class EllMatrix:
    """Column-oriented ELL ("ELL-transpose") sparse matrix.

    Stores, for each *column* j, the row indices and values of its nonzeros,
    padded to the max per-column count ``k``:

      rows: (n, k) int32  — row index of each nonzero (0 where padding)
      vals: (n, k) float  — value of each nonzero (0.0 where padding)

    Chosen over row-ELL because the framework shards A by columns aligned
    with the block sharding of x: A @ x is a per-column scale + segment-sum
    into the m rows (local, then psum over the block axis), and A^T r is a
    pure gather — no scatters (SURVEY.md §7 hard part 2).

    INVARIANT: no duplicate (row, col) coordinates.  Linear consumers
    (matvec/rmatvec) tolerate duplicates, but diag(A^T A) squares per-slot
    values and silently mis-sizes pairwise-FW transfers when an entry is
    split across slots.  All entry surfaces enforce it (generators and
    ``from_scipy`` coalesce); call ``coalesce()`` on hand-built inputs.
    """

    rows: np.ndarray  # (n, k) int32
    vals: np.ndarray  # (n, k)
    num_rows: int

    @property
    def shape(self):
        return (self.num_rows, self.rows.shape[0])

    @property
    def k(self) -> int:
        return self.rows.shape[1]

    @property
    def nnz(self) -> int:
        return int(np.count_nonzero(self.vals))

    def coalesce(self) -> "EllMatrix":
        """Merge duplicate (row, col) coordinates (vals sum) and compact
        columns, shrinking k to the post-merge max nnz.

        Duplicate coordinates are an EllMatrix INVARIANT VIOLATION for any
        consumer that is nonlinear in the stored values — diag(A^T A)
        (pairwise-FW curvature sizing) squares per-slot values, and
        (a+a)^2 != a^2 + a^2.  The linear matvec/rmatvec paths tolerate
        duplicates, which is exactly why this bug class is silent: solves
        stay feasible and descend, just with wrong Newton sizing.  All
        data-entry surfaces (synthetic generators that sample with
        replacement, from_scipy) coalesce; call this on hand-built inputs.
        Vectorised over columns (one argsort + one k-loop), no Python
        per-column loop.
        """
        order = np.argsort(self.rows, axis=1, kind="stable")
        r = np.take_along_axis(self.rows, order, 1)
        v = np.take_along_axis(self.vals, order, 1)
        k = r.shape[1]
        # right-to-left: fold each duplicate's value into its run head
        # (padding slots are val==0, so merging them is a no-op)
        for j in range(k - 1, 0, -1):
            dup = r[:, j] == r[:, j - 1]
            v[:, j - 1] += np.where(dup, v[:, j], 0)
            v[:, j] = np.where(dup, 0, v[:, j])
        # compact nonzeros left (stable), then trim all-padding tail slots
        keep = np.argsort(v == 0, axis=1, kind="stable")
        r = np.take_along_axis(r, keep, 1)
        v = np.take_along_axis(v, keep, 1)
        k_new = max(int(np.count_nonzero(v, axis=1).max()) if r.size else 1, 1)
        r = np.where(v[:, :k_new] != 0, r[:, :k_new], 0).astype(np.int32)
        return EllMatrix(rows=r, vals=v[:, :k_new], num_rows=self.num_rows)

    @staticmethod
    def from_csc(indptr, indices, data, num_rows: int) -> "EllMatrix":
        """Build from raw CSC components WITHOUT a scipy intermediate —
        the scale ingestion path (.mat v7.3 stores CSC directly; 48M-nnz
        instances must load in seconds).  One O(nnz) pass through the
        native engine (bsls_tpu/native, numpy fallback).  The components
        must be canonical (no duplicate rows within a column) — MATLAB and
        scipy both guarantee this; call ``coalesce()`` on hand-built data.
        """
        from ..native import csc_ell

        rows, vals = csc_ell(indptr, indices, data)
        return EllMatrix(rows=rows, vals=vals, num_rows=num_rows)

    @staticmethod
    def from_scipy(A) -> "EllMatrix":
        # one native O(nnz) pass (no per-column loop, no key vectors): the
        # .mat ingestion path must handle multi-million-column instances in
        # seconds
        import scipy.sparse as sp

        A = sp.csc_matrix(A)
        A.sum_duplicates()  # the coalesced-coordinates invariant (coalesce())
        m, n = A.shape
        return EllMatrix.from_csc(A.indptr, A.indices, A.data, m)

    def matvec(self, x: np.ndarray) -> np.ndarray:
        contrib = (self.vals * x[:, None]).ravel()
        return np.bincount(
            self.rows.ravel(), weights=contrib, minlength=self.num_rows
        ).astype(np.result_type(self.vals, x))

    def rmatvec(self, r: np.ndarray) -> np.ndarray:
        return (self.vals * r[self.rows]).sum(axis=1)

    def to_scipy(self):
        import scipy.sparse as sp

        n, k = self.rows.shape
        cols = np.repeat(np.arange(n), k)
        mask = self.vals.ravel() != 0
        return sp.csr_matrix(
            (self.vals.ravel()[mask], (self.rows.ravel()[mask], cols[mask])),
            shape=self.shape,
        )


@dataclass(frozen=True)
class VStackMatrix:
    """Vertical stack [A1; A2]: used by the augmented-Lagrangian solver to
    form [A; sqrt(rho) C] without densifying or re-encoding either part."""

    top: "DenseMatrix | EllMatrix"
    bottom: "DenseMatrix | EllMatrix"

    @property
    def shape(self):
        return (self.top.shape[0] + self.bottom.shape[0], self.top.shape[1])

    def matvec(self, x: np.ndarray) -> np.ndarray:
        return np.concatenate([self.top.matvec(x), self.bottom.matvec(x)])

    def rmatvec(self, r: np.ndarray) -> np.ndarray:
        m1 = self.top.shape[0]
        return self.top.rmatvec(r[:m1]) + self.bottom.rmatvec(r[m1:])

    def to_scipy(self):
        # keeps the eq mesh refine path (refine_polish with dp=None on the
        # stacked problem) on the CSR/native-SpMM host fast path instead of
        # falling back to the ~10x slower per-scenario bincount matvec loop
        import scipy.sparse as sp

        return sp.vstack([sp.csr_matrix(self.top.to_scipy()),
                          sp.csr_matrix(self.bottom.to_scipy())],
                         format="csr")


@dataclass(frozen=True)
class ScaledMatrix:
    """scale * M, lazily applied (used for sqrt(rho) C in augmented systems)."""

    inner: "DenseMatrix | EllMatrix"
    scale: float

    @property
    def shape(self):
        return self.inner.shape

    def matvec(self, x: np.ndarray) -> np.ndarray:
        return self.scale * self.inner.matvec(x)

    def rmatvec(self, r: np.ndarray) -> np.ndarray:
        return self.scale * self.inner.rmatvec(r)

    def to_scipy(self):
        import scipy.sparse as sp

        M = self.inner.to_scipy()
        return (self.scale * sp.csr_matrix(M) if sp.issparse(M)
                else self.scale * np.asarray(M))


def _load_mat73(path: str) -> dict:
    """Read a MATLAB v7.3 (HDF5) .mat: scipy.io.loadmat raises
    NotImplementedError on these.  MATLAB stores dense arrays transposed
    (column-major) and sparse matrices as a group of CSC components
    (data/ir/jc) whose row count lives in the MATLAB_sparse attribute."""
    import h5py

    def read(node, is_matrix):
        if isinstance(node, h5py.Group):  # sparse CSC components
            # straight CSC -> EllMatrix (native one-pass encode): no scipy
            # intermediate, whose constructor re-validates and copies the
            # 48M-nnz index arrays.  MATLAB sparse storage is canonical
            # (sorted, deduplicated), which from_csc requires.
            data = np.asarray(node["data"]).ravel()
            ir = np.asarray(node["ir"]).ravel()
            jc = np.asarray(node["jc"]).ravel().astype(np.int64)
            nrows = int(node.attrs["MATLAB_sparse"])
            return EllMatrix.from_csc(jc, ir, data, nrows)
        arr = np.asarray(node)
        if is_matrix:  # matrices stay 2-D even with a singleton dim
            return arr.T if arr.ndim == 2 else arr.reshape(1, -1)
        return arr.ravel()

    out = {}
    with h5py.File(path, "r") as f:
        for key in ("A", "b", "block_sizes", "C", "d", "x_true"):
            if key in f:
                out[key] = read(f[key], is_matrix=key in ("A", "C"))
    return out


@dataclass(frozen=True)
class Problem:
    """Block-simplex-constrained least squares instance.

        minimize    0.5 * ||A x - b||^2
        subject to  x in Delta_{n_1} x ... x Delta_{n_B}
                    (optionally)  C x = d

    ``b`` may be (m,) or (S, m) for S batched scenarios (multi-RHS).
    """

    A: DenseMatrix | EllMatrix
    b: np.ndarray
    partition: BlockPartition
    C: Optional[DenseMatrix | EllMatrix] = None
    d: Optional[np.ndarray] = None
    name: str = "problem"
    x_true: Optional[np.ndarray] = None  # ground-truth flow, if synthetic

    def __post_init__(self):
        m, n = self.A.shape
        if n != self.partition.n_flat:
            raise ValueError(f"A has {n} columns but partition has n_flat={self.partition.n_flat}")
        b = np.asarray(self.b)
        if b.shape[-1] != m:
            raise ValueError(f"b last dim {b.shape[-1]} != m={m}")
        if (self.C is None) != (self.d is None):
            raise ValueError("C and d must be given together")
        if self.C is not None and self.C.shape[1] != n:
            raise ValueError("C column count mismatch")

    @property
    def num_scenarios(self) -> int:
        b = np.asarray(self.b)
        return 1 if b.ndim == 1 else b.shape[0]

    @property
    def shape(self):
        return self.A.shape

    @staticmethod
    def from_arrays(A, b, block_sizes, C=None, d=None, name="problem",
                    x_true=None, block_multiple: int = 1) -> "Problem":
        """Build from raw arrays; scipy-sparse ``A``/``C`` become EllMatrix."""
        import scipy.sparse as sp

        def wrap(M):
            if M is None:
                return None
            if sp.issparse(M):
                return EllMatrix.from_scipy(M)
            if isinstance(M, (DenseMatrix, EllMatrix)):
                return M
            return DenseMatrix(np.asarray(M))

        part = BlockPartition.from_sizes(block_sizes, block_multiple=block_multiple)
        return Problem(A=wrap(A), b=np.asarray(b), partition=part,
                       C=wrap(C), d=None if d is None else np.asarray(d),
                       name=name, x_true=x_true)

    # ---- host-side objective helpers (float64, for oracles/tests) ----

    def objective_np(self, x_flat: np.ndarray):
        """0.5||Ax-b||^2 in float64; (S, N) x against (S, m) b returns (S,)."""
        x = np.asarray(x_flat, dtype=np.float64)
        b = np.asarray(self.b, dtype=np.float64)
        if x.ndim == 2:
            r = np.stack([self.A.matvec(x[s]) for s in range(x.shape[0])]) - b
            return 0.5 * np.sum(r * r, axis=-1)
        r = self.A.matvec(x) - b
        return 0.5 * float(r @ r)

    def gradient_np(self, x_flat: np.ndarray) -> np.ndarray:
        r = self.A.matvec(np.asarray(x_flat, dtype=np.float64)) - np.asarray(
            self.b, dtype=np.float64
        )
        return self.A.rmatvec(r)

    def save_npz(self, path: str) -> None:
        """Serialise to .npz (the framework's native instance format)."""
        payload = dict(
            b=self.b,
            block_sizes=self.partition.sizes,
            name=np.array(self.name),
        )
        if isinstance(self.A, DenseMatrix):
            payload["A_dense"] = self.A.data
        else:
            payload["A_rows"] = self.A.rows
            payload["A_vals"] = self.A.vals
            payload["A_num_rows"] = np.array(self.A.num_rows)
        if self.C is not None:
            if isinstance(self.C, DenseMatrix):
                payload["C_dense"] = self.C.data
            else:  # keep sparse constraints sparse on disk
                payload["C_rows"] = self.C.rows
                payload["C_vals"] = self.C.vals
                payload["C_num_rows"] = np.array(self.C.num_rows)
            payload["d"] = self.d
        if self.x_true is not None:
            payload["x_true"] = self.x_true
        np.savez_compressed(path, **payload)

    @staticmethod
    def load(path: str) -> "Problem":
        """Load a .npz instance (or a MATLAB .mat with A/b/block_sizes keys,
        matching the reference's expected on-disk format, SURVEY.md §2 #13).
        Both classic (v5-v7, via scipy) and HDF5-based (v7.3, via h5py) .mat
        files are supported — large real-network instances are typically
        saved with '-v7.3'."""
        if str(path).endswith(".mat"):
            from scipy.io import loadmat

            try:
                raw = loadmat(path)
            except (NotImplementedError, ValueError):
                # MATLAB v7.3 = HDF5 container (scipy raises
                # NotImplementedError with the MATLAB userblock header,
                # ValueError on a bare HDF5 file).  Only fall back when the
                # file really is one of those — a corrupt classic .mat
                # should surface scipy's error, not a phantom h5py one.
                with open(path, "rb") as fh:
                    head = fh.read(19)
                if not (head.startswith(b"MATLAB 7.3")
                        or head.startswith(b"\x89HDF")):
                    raise
                raw = _load_mat73(path)
            A = raw["A"]
            b = np.asarray(raw["b"]).ravel()
            sizes = np.asarray(raw["block_sizes"]).ravel()
            C = raw.get("C")
            d = raw.get("d")
            d = None if d is None else np.asarray(d).ravel()
            x_true = raw.get("x_true")
            x_true = None if x_true is None else np.asarray(x_true).ravel()
            return Problem.from_arrays(A, b, sizes, C=C, d=d, x_true=x_true, name=str(path))
        raw = np.load(path, allow_pickle=False)
        if "A_dense" in raw:
            A = DenseMatrix(raw["A_dense"])
        else:
            A = EllMatrix(rows=raw["A_rows"], vals=raw["A_vals"], num_rows=int(raw["A_num_rows"]))
        if "C_dense" in raw:
            C = DenseMatrix(raw["C_dense"])
        elif "C_rows" in raw:
            C = EllMatrix(rows=raw["C_rows"], vals=raw["C_vals"],
                          num_rows=int(raw["C_num_rows"]))
        else:
            C = None
        d = raw["d"] if "d" in raw else None
        x_true = raw["x_true"] if "x_true" in raw else None
        part = BlockPartition.from_sizes(raw["block_sizes"])
        return Problem(A=A, b=raw["b"], partition=part, C=C, d=d,
                       name=str(raw.get("name", "problem")), x_true=x_true)
