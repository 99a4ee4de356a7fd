"""Dense-matrix handles and the two-level partitioning model (PyTorch port of
repro.core.matrix).

``FMMatrix`` is an immutable handle; physical storage lives behind the
``MatrixStore`` protocol.  The port has the device tier (a ``DenseStore``
over a tensor on the engine's device), the host-RAM tier (a ``DenseStore``
over a numpy array, staged onto the device a partition at a time by the
streaming executor) and the disk tier (``storage.MmapStore`` over an
``.fmat`` file, staged the same way); the sparse
``storage.sparse.SparseEllStore`` holds an ELL slab on the device or in
host RAM, and ``storage.sparse.CsrMmapStore`` a CSR ``.fmat`` on disk.
The partition-size rules are the reference's, bit for bit, so plans,
signatures and counters match.
"""
from __future__ import annotations

import abc
import dataclasses
import warnings
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
    """In-memory backing: ``data`` is a tensor on the engine's device (the
    device tier) or a numpy array in host RAM (the host tier, in the host
    staging type of its dtype: bf16 as float32, as in the reference).  A
    'col'-layout store holds the transposed buffer, shape (ncol, nrow)."""

    data: Any
    layout: str = "row"

    @property
    def on_host(self) -> bool:
        return isinstance(self.data, np.ndarray)

    def logical(self):
        return self.data.T if self.layout == "col" else self.data

    def block(self, start: int, stop: int):
        if self.layout == "col":
            return self.data[:, start:stop].T
        return self.data[start:stop]

    def nbytes(self) -> int:
        return int(self.data.nbytes)

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
    def from_array(arr, *, layout: str = "row", name: str = "",
                   host: bool = False) -> "FMMatrix":
        """Wrap a tensor or numpy array on the engine's device, or with
        ``host=True`` in host RAM as numpy (1-D arrays become one-column
        matrices), in its canonical dtype."""
        if host:
            if not isinstance(arr, torch.Tensor):
                arr = np.asarray(arr)
            dtype = dtypes.canon(arr.dtype)
            data = to_host(arr)
        else:
            data = to_device(arr)
            dtype = data.dtype
        if data.ndim == 1:
            data = data.reshape(-1, 1)
        shape = tuple(data.shape)
        if layout == "col":
            data = data.T
        return FMMatrix(shape, dtype, store=DenseStore(data, layout),
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
                else "sparse disk" if self.is_sparse and self.on_disk
                else "sparse host" if self.is_sparse and self.on_host
                else "sparse device" if self.is_sparse
                else "disk" if self.on_disk
                else "host" if self.on_host else "device")
        return (f"FMMatrix({self.nrow}x{self.ncol}, "
                f"{dtypes.name(self.dtype)}, {kind}"
                + (f", name={self.name!r}" if self.name else "") + ")")


def to_device(arr) -> torch.Tensor:
    """A tensor on the engine's device in its canonical dtype.  numpy input
    takes the reference's canon (float64 → float32, int64 → int32), so the
    same numpy arrays compute the same thing in both packages.  A
    read-only array (a disk matrix's memory map) is read, never written: on
    the CPU device the tensor shares its pages."""
    from ..storage import registry  # deferred: storage imports core
    dev = registry.device()
    if isinstance(arr, torch.Tensor):
        t = arr
    else:
        a = np.asarray(arr)
        a = a.astype(dtypes.np_equiv(dtypes.canon(a.dtype)), copy=False)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # not writable
            t = torch.from_numpy(np.ascontiguousarray(a))
    return dtypes.to_canon(t).to(dev)


def to_host(arr) -> np.ndarray:
    """A numpy array in host RAM in the host staging type of its canonical
    dtype (``dtypes.np_equiv``: float64 → float32, int64 → int32, bf16 →
    float32); a numpy input already in that type is not copied, as in the
    reference."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return np.asarray(t.cpu().numpy(),
                          dtype=dtypes.np_equiv(dtypes.canon(arr.dtype)))
    a = np.asarray(arr)
    return np.asarray(a, dtype=dtypes.np_equiv(dtypes.canon(a.dtype)))


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
    engine's device, or with ``host=True`` in host RAM (the out-of-core
    tier the ``ooc`` mode streams from).  It takes exactly what ``repro``'s
    ``fm.as_np`` returns, with the same dtype canon.  Like ``materialize``,
    it raises when the engine's device is a CUDA device and no card is
    present, whichever tier is asked for."""
    from ..storage import registry  # deferred: storage imports core
    registry.device()
    return FMMatrix.from_array(arr, host=host)


def conv_FM2R(mat: FMMatrix) -> np.ndarray:
    """fm.conv.FM2R: to a host numpy array (materializes virtuals; bf16
    comes back as float32, the host staging type)."""
    if mat.is_virtual:
        from . import materialize as _mat
        mat = _mat.materialize(mat)[0]
    data = mat.logical_data()
    if isinstance(data, np.ndarray):
        return np.asarray(data)
    if data.dtype == torch.bfloat16:
        data = data.to(torch.float32)
    return data.detach().cpu().numpy()


def conv_layout(mat: FMMatrix, layout: str) -> FMMatrix:
    """fm.conv.layout: physically convert row/col majority: a DenseStore
    over a buffer laid out as asked (a 'col' store holds the transposed
    buffer, contiguous); a matrix already in that layout is returned as it
    is.  A device or host matrix stays on its tier; a disk matrix is read
    into a host-RAM store, as in the reference."""
    if layout not in ("row", "col"):
        raise ValueError(f"unknown layout {layout!r}: expected 'row' or 'col'")
    data = mat.logical_data()
    if layout == mat.store.layout:
        return mat
    buf = data.T if layout == "col" else data
    buf = (np.ascontiguousarray(buf) if isinstance(buf, np.ndarray)
           else buf.contiguous())
    return FMMatrix(mat.shape, mat.dtype, store=DenseStore(buf, layout),
                    name=mat.name)


def conv_store(mat: FMMatrix, where: str, *, name: str = "") -> FMMatrix:
    """fm.conv.store: move a physical matrix between tiers ('device' | 'host'
    | 'disk').  ``where='disk'`` writes the matrix into the configured data
    directory under ``name`` (or the matrix's own name) and returns a
    handle backed by ``storage.MmapStore`` (a sparse matrix: a CSR ``.fmat``
    behind ``storage.CsrMmapStore``).  A sparse matrix moves in its sparse
    form: only its cols/vals migrate, to a host ELL slab or a device one."""
    if where not in ("host", "device", "disk"):
        raise ValueError(f"unknown store {where!r}")
    if where == "disk":
        from ..storage import registry  # deferred: storage imports core
        if mat.is_sparse:
            return registry.save_sparse_matrix(mat, name or mat.name or None)
        return registry.save_dense_matrix(mat, name or mat.name or None)
    if mat.is_sparse:
        from ..storage.sparse import SparseEllStore  # deferred: storage imports core
        blk = mat.store.block(0, mat.nrow)
        move = to_host if where == "host" else to_device
        store = SparseEllStore(move(blk.cols), move(blk.vals), mat.ncol,
                               nnz=getattr(mat.store, "nnz", None))
        return FMMatrix(mat.shape, store.dtype, store=store,
                        name=name or mat.name)
    # As in the reference, a move takes the dtype of the buffer it moves:
    # a host bf16 matrix (a float32 buffer) reaches the device as float32.
    data = mat.logical_data()
    if where == "host":
        return FMMatrix.from_array(data, name=name or mat.name, host=True)
    return FMMatrix.from_array(data, name=name or mat.name)
