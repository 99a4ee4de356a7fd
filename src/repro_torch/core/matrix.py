"""Dense-matrix handles and the two-level partitioning model (PyTorch port of
repro.core.matrix).

``FMMatrix`` is an immutable handle; physical storage lives behind the
``MatrixStore`` protocol.  The port has the device tier: a ``DenseStore``
over a tensor on the engine's device, and the sparse
``storage.sparse.SparseEllStore`` over an ELL slab.  The host-RAM and disk
tiers come with ROADMAP A7.  The partition-size rules are the reference's,
bit for bit, so plans, signatures and counters match.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from . import dtypes

# ---------------------------------------------------------------------------
# Partition-size policy (identical to the reference)
# ---------------------------------------------------------------------------

#: I/O-level partition budget: bytes of a fused group's working set.
IO_PARTITION_BYTES = 64 * 1024 * 1024

#: Processor-level (second tier) partition budget of the per-segment
#: schedule; settable via ``fm.set_conf(vmem_partition_bytes=...)`` and part
#: of the plan-cache key.  The CUDA kernels pick their own tiling; this value
#: keeps the plan IR and its signatures identical to the reference's.
VMEM_PARTITION_BYTES = 4 * 1024 * 1024

ROW_ALIGN = 8

_HOST_TIER = ("the host-RAM and disk tiers come with the disk-tier slice "
              "(ROADMAP A7)")


def _pow2_rows(ncol: int, dtype, n_live: int, budget_bytes: int) -> int:
    """Largest power of two rows such that ``n_live`` arrays of that many
    rows fit the byte budget (paper: partitions are always 2^i rows)."""
    row_bytes = max(1, ncol) * dtypes.nbytes(dtype) * max(1, n_live)
    rows = max(ROW_ALIGN, budget_bytes // max(1, row_bytes))
    return 1 << (int(rows).bit_length() - 1)


def io_partition_rows(ncol: int, dtype, n_live: int = 1,
                      budget_bytes: Optional[int] = None) -> int:
    if budget_bytes is None:
        budget_bytes = IO_PARTITION_BYTES
    return _pow2_rows(ncol, dtype, n_live, budget_bytes)


def proc_partition_rows(ncol: int, dtype, n_live: int = 1,
                        budget_bytes: Optional[int] = None) -> int:
    if budget_bytes is None:
        budget_bytes = VMEM_PARTITION_BYTES
    return _pow2_rows(ncol, dtype, n_live, budget_bytes)


# ---------------------------------------------------------------------------
# Storage
# ---------------------------------------------------------------------------

class MatrixStore(abc.ABC):
    """Store protocol: the physical backing of a materialized matrix (see
    repro.core.matrix.MatrixStore)."""

    layout: str = "row"  # 'row' | 'col'

    @property
    @abc.abstractmethod
    def on_host(self) -> bool:
        """True when partitions must be staged host→device."""

    @property
    def on_disk(self) -> bool:
        return False

    @abc.abstractmethod
    def logical(self):
        """Data in logical (nrow, ncol) orientation (may be a view)."""

    @abc.abstractmethod
    def block(self, start: int, stop: int):
        """Logical rows [start, stop)."""

    @abc.abstractmethod
    def nbytes(self) -> int:
        """Physical size of the backing buffer in bytes."""

    @abc.abstractmethod
    def transposed(self) -> "MatrixStore":
        """A store over the same buffer with the layout tag flipped."""


@dataclasses.dataclass
class DenseStore(MatrixStore):
    """Device-tier backing: ``data`` is a tensor on the engine's device.  A
    'col'-layout store holds the transposed buffer, shape (ncol, nrow)."""

    data: Any
    layout: str = "row"

    @property
    def on_host(self) -> bool:
        return False

    def logical(self):
        return self.data.T if self.layout == "col" else self.data

    def block(self, start: int, stop: int):
        if self.layout == "col":
            return self.data[:, start:stop].T
        return self.data[start:stop]

    def nbytes(self) -> int:
        return int(self.data.numel() * self.data.element_size())

    def transposed(self) -> "DenseStore":
        return DenseStore(self.data, "col" if self.layout == "row" else "row")


class FMMatrix:
    """Immutable matrix handle.  Exactly one of ``store`` (physical) and
    ``node`` (virtual: a dag.Node) is set."""

    __slots__ = ("shape", "dtype", "store", "node", "name", "_transposed_of")

    def __init__(self, shape, dtype, *, store: Optional[MatrixStore] = None,
                 node=None, name: str = ""):
        if (store is None) == (node is None):
            raise ValueError("an FMMatrix has exactly one backing")
        self.shape = (int(shape[0]), int(shape[1]))
        self.dtype = dtypes.canon(dtype)
        self.store = store
        self.node = node
        self.name = name
        self._transposed_of: Optional[FMMatrix] = None

    @property
    def nrow(self) -> int:
        return self.shape[0]

    @property
    def ncol(self) -> int:
        return self.shape[1]

    @property
    def is_virtual(self) -> bool:
        return self.node is not None

    @property
    def is_tall(self) -> bool:
        return self.nrow >= self.ncol

    @property
    def long_dim(self) -> int:
        return max(self.shape)

    @property
    def long_axis(self) -> int:
        return 0 if self.is_tall else 1

    @property
    def on_host(self) -> bool:
        return self.store is not None and self.store.on_host

    @property
    def on_disk(self) -> bool:
        return self.store is not None and self.store.on_disk

    @property
    def is_sparse(self) -> bool:
        """True for a physical matrix on the sparse (ELL) tier."""
        return self.store is not None and getattr(self.store, "sparse", False)

    def nbytes(self) -> int:
        """Bytes a pass moves for this matrix: the store's own count (on the
        sparse tier the slab's, not nrow·ncol·itemsize)."""
        if self.store is not None:
            return int(self.store.nbytes())
        return self.nrow * self.ncol * dtypes.nbytes(self.dtype)

    @staticmethod
    def from_array(arr, *, layout: str = "row", name: str = "") -> "FMMatrix":
        """Wrap a tensor or numpy array on the engine's device (1-D arrays
        become one-column matrices), in its canonical dtype."""
        data = to_device(arr)
        if data.ndim == 1:
            data = data.reshape(-1, 1)
        shape = tuple(data.shape)
        if layout == "col":
            data = data.T
        return FMMatrix(shape, data.dtype, store=DenseStore(data, layout),
                        name=name)

    def transpose(self) -> "FMMatrix":
        """Lazy transpose: no data movement, flip the layout tag."""
        if self.store is not None:
            out = FMMatrix((self.ncol, self.nrow), self.dtype,
                           store=self.store.transposed(),
                           name=f"t({self.name})" if self.name else "")
        else:
            out = FMMatrix((self.ncol, self.nrow), self.dtype, node=self.node,
                           name=f"t({self.name})" if self.name else "")
        out._transposed_of = self
        return out

    @property
    def transposed_of(self) -> Optional["FMMatrix"]:
        return self._transposed_of

    def logical_data(self):
        if self.store is None:
            raise ValueError(
                f"matrix {self.name or '<anon>'} is virtual; call "
                "fm.materialize() first")
        return self.store.logical()

    def block(self, start: int, stop: int):
        if self.store is None:
            raise ValueError(
                f"matrix {self.name or '<anon>'} is virtual; call "
                "fm.materialize() first")
        return self.store.block(start, stop)

    def __repr__(self):
        kind = ("virtual" if self.is_virtual
                else "sparse device" if self.is_sparse else "device")
        return (f"FMMatrix({self.nrow}x{self.ncol}, "
                f"{dtypes.name(self.dtype)}, {kind}"
                + (f", name={self.name!r}" if self.name else "") + ")")


def to_device(arr) -> torch.Tensor:
    """A tensor on the engine's device in its canonical dtype.  numpy input
    takes the reference's canon (float64 → float32, int64 → int32), so the
    same numpy arrays compute the same thing in both packages."""
    from ..storage import registry  # deferred: storage imports core
    dev = registry.device()
    if isinstance(arr, torch.Tensor):
        t = arr
    else:
        a = np.asarray(arr)
        a = a.astype(dtypes.np_equiv(dtypes.canon(a.dtype)), copy=False)
        t = torch.from_numpy(np.ascontiguousarray(a))
    return dtypes.to_canon(t).to(dev)


# ---------------------------------------------------------------------------
# Construction utilities (paper Table II)
# ---------------------------------------------------------------------------

def rep_int(value, n: int, dtype=torch.float32) -> FMMatrix:
    """fm.rep.int: vector with a repeated value."""
    return FMMatrix.from_array(torch.full((n,), value,
                                          dtype=dtypes.canon(dtype)))


def seq_int(n: int, dtype=torch.int64) -> FMMatrix:
    """fm.seq.int: 0..n-1 sequence vector."""
    return FMMatrix.from_array(torch.arange(n, dtype=dtypes.canon(dtype)))


def _generator(seed: int) -> torch.Generator:
    from ..storage import registry
    g = torch.Generator(device=registry.device())
    g.manual_seed(int(seed))
    return g


def runif_matrix(nrow: int, ncol: int, *, seed: int = 0,
                 dtype=torch.float32, minval=0.0, maxval=1.0) -> FMMatrix:
    """fm.runif.matrix: uniform random matrix drawn on the engine's device
    from a ``torch.Generator`` seeded with ``seed``.  (The reference draws
    from JAX PRNG keys; the two streams differ.)"""
    from ..storage import registry
    g = _generator(seed)
    x = torch.empty((nrow, ncol), dtype=dtypes.canon(dtype),
                    device=registry.device())
    x.uniform_(minval, maxval, generator=g)
    return FMMatrix.from_array(x)


def rnorm_matrix(nrow: int, ncol: int, *, seed: int = 0,
                 dtype=torch.float32, mean=0.0, sd=1.0) -> FMMatrix:
    """fm.rnorm.matrix: normal random matrix (see runif_matrix)."""
    from ..storage import registry
    g = _generator(seed)
    x = torch.empty((nrow, ncol), dtype=dtypes.canon(dtype),
                    device=registry.device())
    x.normal_(mean, sd, generator=g)
    return FMMatrix.from_array(x)


def conv_R2FM(arr, *, host: bool = False) -> FMMatrix:
    """fm.conv.R2FM: wrap an external array (numpy or tensor) on the
    engine's device.  It takes exactly what ``repro``'s ``fm.as_np``
    returns, with the same dtype canon."""
    if host:
        raise NotImplementedError(_HOST_TIER)
    return FMMatrix.from_array(arr)


def conv_FM2R(mat: FMMatrix) -> np.ndarray:
    """fm.conv.FM2R: to a host numpy array (materializes virtuals; bf16
    comes back as float32, the host staging type)."""
    if mat.is_virtual:
        from . import materialize as _mat
        mat = _mat.materialize(mat)[0]
    data = mat.logical_data()
    if data.dtype == torch.bfloat16:
        data = data.to(torch.float32)
    return data.detach().cpu().numpy()


def conv_store(mat: FMMatrix, where: str, *, name: str = "") -> FMMatrix:
    """fm.conv.store: only the device tier exists in this slice.  A sparse
    matrix moves in its sparse form: only its cols/vals migrate."""
    if where == "device" and mat.is_sparse:
        from ..storage.sparse import SparseEllStore  # deferred: storage imports core
        blk = mat.store.block(0, mat.nrow)
        store = SparseEllStore(to_device(blk.cols), to_device(blk.vals),
                               mat.ncol, nnz=getattr(mat.store, "nnz", None))
        return FMMatrix(mat.shape, mat.dtype, store=store,
                        name=name or mat.name)
    if where == "device":
        return FMMatrix.from_array(mat.logical_data(), name=name or mat.name)
    if where in ("host", "disk"):
        raise NotImplementedError(_HOST_TIER)
    raise ValueError(f"unknown store {where!r}")
