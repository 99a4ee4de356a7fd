"""R-base-like matrix API on GenOps (paper Table III), PyTorch port of
repro.core.rlike.

`FM` wraps an FMMatrix handle with R's operator vocabulary; every method
lowers to a GenOp, so a chain of calls builds one lazy DAG that
``fm.materialize`` fuses.

    >>> X = fm.runif_matrix(1_000_000, 16)
    >>> Z = (X - fm.colMeans(X)) / fm.colSds(X)   # lazy: moment + sweep passes
    >>> (G,) = fm.materialize(fm.crossprod(Z))
"""
from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from . import dtypes, genops, materialize as mat_mod, matrix as matrix_mod
from .matrix import FMMatrix


class FM:
    """R-flavoured wrapper around an FMMatrix handle (virtual or physical)."""

    __slots__ = ("m",)

    def __init__(self, m: FMMatrix):
        self.m = m

    @property
    def shape(self):
        return self.m.shape

    @property
    def nrow(self):
        return self.m.nrow

    @property
    def ncol(self):
        return self.m.ncol

    @property
    def dtype(self):
        return self.m.dtype

    @property
    def is_virtual(self):
        return self.m.is_virtual

    def __repr__(self):
        return f"FM({self.m!r})"

    # -- element-wise binary (auto row/col recycling like R sweep) -----------
    def _bin(self, other, op):
        if isinstance(other, FM):
            if other.shape == self.shape:
                return FM(genops.mapply(self.m, other.m, op))
            return self._recycle(other, op)
        return FM(genops.mapply(self.m, other, op))

    def _rbin(self, other, op):
        return FM(genops.mapply(other, self.m, op))

    def _recycle(self, other: "FM", op):
        """R-style recycling of a vector across a matrix: length ncol pairs
        with each column index (mapply.row), length nrow with each row index
        (mapply.col; also the square case, R being column-major).  A virtual
        length-ncol vector stays lazy (the multi-pass schedule)."""
        n = max(other.shape)
        if min(other.shape) != 1:
            raise ValueError(
                f"recycling needs a vector (an n×1 or 1×n matrix); got "
                f"shape {other.shape} against {self.shape} — for "
                f"elementwise matrix∘matrix the shapes must match exactly")
        if n == self.ncol and n != self.nrow:
            vec = other.m if other.m.is_virtual else _vec_data(other.m)
            return FM(genops.mapply_row(self.m, vec, op))
        if n == self.nrow:
            return FM(genops.mapply_col(self.m, other.m, op))
        raise ValueError(
            f"cannot recycle a length-{n} vector across a "
            f"{self.nrow}×{self.ncol} matrix: R recycling needs length "
            f"{self.nrow} (pairs with each row index, mapply.col) or "
            f"{self.ncol} (pairs with each column index, mapply.row)")

    def __add__(self, o):
        return self._bin(o, "add")

    def __radd__(self, o):
        return self._rbin(o, "add")

    def __sub__(self, o):
        return self._bin(o, "sub")

    def __rsub__(self, o):
        return self._rbin(o, "sub")

    def __mul__(self, o):
        return self._bin(o, "mul")

    def __rmul__(self, o):
        return self._rbin(o, "mul")

    def __truediv__(self, o):
        return self._bin(o, "div")

    def __rtruediv__(self, o):
        return self._rbin(o, "div")

    def __pow__(self, o):
        if isinstance(o, (int, float)) and o == 2:
            return FM(genops.sapply(self.m, "sq"))
        return self._bin(o, "pow")

    def __neg__(self):
        return FM(genops.sapply(self.m, "neg"))

    def __eq__(self, o):  # noqa: A003 - R semantics, not identity
        return self._bin(o, "eq")

    def __ne__(self, o):
        return self._bin(o, "neq")

    def __lt__(self, o):
        return self._bin(o, "lt")

    def __le__(self, o):
        return self._bin(o, "le")

    def __gt__(self, o):
        return self._bin(o, "gt")

    def __ge__(self, o):
        return self._bin(o, "ge")

    def __hash__(self):
        return id(self)

    def __matmul__(self, o):
        """%*%: matrix multiplication with the (mul, sum) semiring."""
        rhs = o.m if isinstance(o, FM) else o
        return FM(genops.inner_prod(self.m, rhs, "mul", "sum"))

    def t(self) -> "FM":
        return FM(self.m.transpose())

    @property
    def T(self) -> "FM":
        return self.t()


def _vec_data(m: FMMatrix):
    if m.is_virtual:
        (m,) = mat_mod.materialize(m)
    return m.logical_data().reshape(-1)


def _fm(x) -> FMMatrix:
    return x.m if isinstance(x, FM) else x


# ---------------------------------------------------------------------------
# Free functions (R vocabulary)
# ---------------------------------------------------------------------------

def sapply(x, f) -> FM:
    return FM(genops.sapply(_fm(x), f))


def mapply(a, b, f) -> FM:
    return FM(genops.mapply(_fm(a), _fm(b) if isinstance(b, FM) else b, f))


def mapply_row(a, vec, f) -> FM:
    return FM(genops.mapply_row(_fm(a), _fm(vec) if isinstance(vec, FM) else vec, f))


def mapply_col(a, vec, f) -> FM:
    return FM(genops.mapply_col(_fm(a), _fm(vec) if isinstance(vec, FM) else vec, f))


def inner_prod(a, b, f1="mul", f2="sum") -> FM:
    return FM(genops.inner_prod(_fm(a), _fm(b) if isinstance(b, FM) else b, f1, f2))


def agg(x, f) -> FM:
    return FM(genops.agg(_fm(x), f))


def agg_row(x, f) -> FM:
    return FM(genops.agg_row(_fm(x), f))


def agg_col(x, f) -> FM:
    return FM(genops.agg_col(_fm(x), f))


def groupby_row(x, labels, f, num_groups: int) -> FM:
    return FM(genops.groupby_row(_fm(x), _fm(labels) if isinstance(labels, FM)
                                 else labels, f, num_groups))


def groupby_col(x, labels, f, num_groups: int) -> FM:
    return FM(genops.groupby_col(_fm(x), labels, f, num_groups))


def cbind(*xs) -> FM:
    return FM(genops.cbind(*[_fm(x) for x in xs]))


def sqrt(x) -> FM:
    return sapply(x, "sqrt")


def exp(x) -> FM:
    return sapply(x, "exp")


def log(x) -> FM:
    return sapply(x, "log")


def log1p(x) -> FM:
    return sapply(x, "log1p")


def sigmoid(x) -> FM:
    """1 / (1 + exp(-x)) — the logistic link inverse (GLM/IRLS)."""
    return sapply(x, "sigmoid")


def abs_(x) -> FM:
    return sapply(x, "abs")


def pmin(a, b) -> FM:
    return mapply(a, b, "pmin")


def pmax(a, b) -> FM:
    return mapply(a, b, "pmax")


def ifelse0(x, mask) -> FM:
    return mapply(x, mask, "ifelse0")


def is_na(x) -> FM:
    return sapply(x, "isna")


def sum_(x) -> FM:
    return agg(x, "sum")


def rowSums(x) -> FM:
    return agg_row(x, "sum")


def colSums(x) -> FM:
    return agg_col(x, "sum")


def rowMins(x) -> FM:
    return agg_row(x, "min")


def colMins(x) -> FM:
    return agg_col(x, "min")


def rowMaxs(x) -> FM:
    return agg_row(x, "max")


def colMaxs(x) -> FM:
    return agg_col(x, "max")


def which_min_row(x) -> FM:
    """R's apply(X, 1, which.min), zero-based."""
    return agg_row(x, "which.min")


def which_max_row(x) -> FM:
    return agg_row(x, "which.max")


def any_(x) -> FM:
    return agg(x, "any")


def all_(x) -> FM:
    return agg(x, "all")


def colMeans(x) -> FM:
    """R colMeans: the colSums sink divided by n in the plan epilogue."""
    return colSums(x) / float(_fm(x).nrow)


def rowMeans(x) -> FM:
    """R rowMeans: row-local and lazy."""
    return rowSums(x) / float(_fm(x).ncol)


def colSds(x) -> FM:
    """Column standard deviations, fully lazy: two co-materialized sinks
    and an epilogue chain."""
    n = float(_fm(x).nrow)
    s, s2 = colSums(x), colSums(x ** 2)
    var = (s2 - s * s / n) / (n - 1.0)
    return sqrt(pmax(var, 0.0))


def mean_(x) -> FM:
    """R mean(): grand mean over all elements, a lazy 1×1 epilogue value."""
    m = _fm(x)
    return agg(x, "sum") / float(m.nrow * m.ncol)


def sweep(x, margin: int, stat, fun: str = "sub") -> FM:
    """R sweep(): ``margin=2`` pairs ``stat`` with each column index,
    ``margin=1`` with each row index; ``stat`` may be lazy."""
    if margin == 2:
        return mapply_row(x, stat, fun)
    if margin == 1:
        return mapply_col(x, stat, fun)
    raise ValueError(f"sweep margin must be 1 (rows) or 2 (columns), "
                     f"got {margin!r}")


def scale(x, center=True, scale=True, save: Optional[str] = None) -> FM:
    """R scale(): a pure lazy chain that materializes as moment pass →
    sweep pass (``exec_stats()['passes'] == 2``)."""
    z = x if isinstance(x, FM) else FM(x)
    if center:
        z = mapply_row(z, colMeans(x), "sub")
    if scale:
        z = mapply_row(z, colSds(x), "div")
    if save is not None and z.m.is_virtual:
        persist(z, tier=save)
    return z


def crossprod(x, y: Optional[FM] = None) -> FM:
    """R crossprod: t(x) %*% y (y defaults to x) — the Gram sink."""
    y = x if y is None else y
    return FM(genops.inner_prod(_fm(x).transpose(), _fm(y), "mul", "sum"))


def diag(x) -> FM:
    """R diag(): the diagonal of a small matrix, or a diagonal matrix from a
    vector (small-tier math on the host)."""
    arr = conv_FM2R(x) if isinstance(x, FM) else np.asarray(x)
    if arr.ndim == 2 and min(arr.shape) == 1:
        arr = arr.reshape(-1)
    if arr.ndim <= 1:
        return conv_R2FM(np.diag(arr.reshape(-1)))
    return conv_R2FM(np.diag(arr).copy())


def solve(a, b=None) -> FM:
    """R solve(): lazy epilogue op on virtual operands (non-finite values
    propagate on singular systems); physical operands solve eagerly on the
    host in float64 and raise ``LinAlgError``."""
    a_virtual = isinstance(a, FM) and a.is_virtual
    b_virtual = isinstance(b, FM) and b.is_virtual
    if a_virtual or b_virtual:
        return FM(genops.solve(_fm(a), _fm(b) if isinstance(b, FM) else b))
    A = np.asarray(conv_FM2R(a) if isinstance(a, FM) else a, np.float64)
    if b is None:
        return conv_R2FM(np.linalg.inv(A))
    B = np.asarray(conv_FM2R(b) if isinstance(b, FM) else b, np.float64)
    if B.ndim <= 1:
        B = B.reshape(-1, 1)
    return conv_R2FM(np.linalg.solve(A, B))


def rowsum(x, groups, num_groups: int) -> FM:
    """R rowsum: sum rows by group label."""
    return groupby_row(x, groups, "sum", num_groups)


def table_(groups, num_groups: int) -> FM:
    """R table() over integer labels: per-group counts."""
    g = _fm(groups)
    return FM(genops.groupby_row(g, g, "count", num_groups))


# -- construction / conversion ------------------------------------------------
def runif_matrix(nrow, ncol, **kw) -> FM:
    return FM(matrix_mod.runif_matrix(nrow, ncol, **kw))


def rnorm_matrix(nrow, ncol, **kw) -> FM:
    return FM(matrix_mod.rnorm_matrix(nrow, ncol, **kw))


def rep_int(value, n, **kw) -> FM:
    return FM(matrix_mod.rep_int(value, n, **kw))


def seq_int(n, **kw) -> FM:
    return FM(matrix_mod.seq_int(n, **kw))


def conv_R2FM(arr, host: bool = False) -> FM:
    return FM(matrix_mod.conv_R2FM(arr, host=host))


def conv_FM2R(x) -> np.ndarray:
    return matrix_mod.conv_FM2R(_fm(x))


def persist(x, tier: str = "device", *, name: Optional[str] = None) -> FM:
    """fm.persist: the one entry point for keeping a matrix on a tier:
    'device', 'host' (RAM) or 'disk' (an ``.fmat`` file in the data
    directory — FlashR's ``in.mem=FALSE``).  A sparse matrix persists in
    its sparse form (an ELL slab in RAM, a CSR ``.fmat`` on disk); it is
    never densified.

    A virtual ``x`` is marked so its next materialization keeps it on
    ``tier`` (``tier='disk'`` spills the streaming output write-through,
    with no extra pass); a physical one moves now (``tier='disk'`` writes
    it under ``name``, or the matrix's own name, and returns the reopened
    mmap-backed handle).  Returns an FM either way."""
    if tier not in ("device", "host", "disk"):
        raise ValueError(
            f"unknown tier {tier!r}: expected 'device', 'host' or 'disk'")
    m = _fm(x)
    if m.is_virtual:
        genops.set_mate_level(m, tier)
        if name:
            m.name = name
        return x if isinstance(x, FM) else FM(m)
    return FM(matrix_mod.conv_store(m, tier, name=name or ""))


def conv_store(x, where: str, *, name: str = "") -> FM:
    """Deprecated spelling of ``fm.persist(x, tier=where, name=...)``."""
    warnings.warn(
        "fm.conv_store(x, where, name=...) is deprecated; use "
        "fm.persist(x, tier=..., name=...)", DeprecationWarning,
        stacklevel=2)
    return persist(x, tier=where, name=name or None)


def conv_layout(x, layout: str) -> FM:
    """fm.conv.layout: physically convert row/col majority ('row' or
    'col'); a disk matrix is read into host RAM in the new layout."""
    return FM(matrix_mod.conv_layout(_fm(x), layout))


def set_mate_level(x, level: str) -> FM:
    """Deprecated spelling of ``fm.persist(x, tier=level)``."""
    warnings.warn(
        "fm.set_mate_level(x, level) is deprecated; use "
        "fm.persist(x, tier=...)", DeprecationWarning, stacklevel=2)
    return persist(x, tier=level)


def set_conf(**kw) -> dict:
    """fm.set.conf: the reference's knobs plus ``device`` ('cuda' default,
    or 'cpu'); ``mesh`` (a `launch.mesh.Mesh` of the engine's device type,
    ``False`` clears it) shards execution engine-wide.  See
    repro_torch.storage.registry."""
    from ..storage import registry
    return registry.set_conf(**kw)


def conf(**kw):
    """fm.conf: scoped configuration override (a context manager), e.g.
    ``with fm.conf(mesh=mesh):`` for a sharded scope."""
    from ..storage import registry
    return registry.conf(**kw)


# -- the disk tier / EM-matrix registry (repro_torch/storage/) ----------------
def get_dense_matrix(name: str) -> FM:
    """fm.get.dense.matrix: reopen a named on-disk matrix (mmap-backed)."""
    from ..storage import registry
    return FM(registry.get_dense_matrix(name))


def load_dense_matrix(src, name: str, **kw) -> FM:
    """fm.load.dense.matrix: ingest CSV/binary/npy/array → on-disk matrix."""
    from ..storage import registry
    return FM(registry.load_dense_matrix(src, name, **kw))


def load_factor_matrix(src, name: str, *, num_levels, **kw) -> FM:
    """fm.load.factor.matrix: stream a CSV of integer factor columns into
    a CSR on-disk matrix of one-hot rows (the Criteo design matrix) and
    reopen it on the sparse tier."""
    from ..storage import registry
    return FM(registry.load_factor_matrix(src, name, num_levels=num_levels,
                                          **kw))


def save_dense_matrix(x, name: Optional[str] = None, **kw) -> FM:
    """Write a physical matrix into the registry; returns the disk handle
    (a virtual ``x`` is materialized first)."""
    from ..storage import registry
    m = _fm(x)
    if getattr(m, "is_virtual", False):
        (m,) = mat_mod.materialize(m)
    return FM(registry.save_dense_matrix(m, name, **kw))


class Factor:
    """A factor vector (paper Table III ``fm.as.factor``): integer codes in
    ``[0, num_levels)`` plus the level count — what ``fm.one_hot`` consumes
    to build the sparse design-matrix columns."""

    __slots__ = ("codes", "num_levels")

    def __init__(self, codes: np.ndarray, num_levels: int):
        self.codes = codes
        self.num_levels = int(num_levels)

    def __len__(self):
        return int(self.codes.shape[0])

    def __repr__(self):
        return f"Factor(n={len(self)}, num_levels={self.num_levels})"


def as_factor(x, num_levels: Optional[int] = None) -> Factor:
    """fm.as.factor: integer labels → a factor vector.  ``x`` is an FM,
    FMMatrix or array of integer-valued labels (one column); ``num_levels``
    defaults to ``max(code) + 1``; codes must lie in ``[0, num_levels)``."""
    if isinstance(x, Factor):
        return x if num_levels is None else Factor(x.codes, num_levels)
    arr = np.asarray(conv_FM2R(x) if isinstance(x, (FM, FMMatrix)) else x)
    codes = arr.reshape(-1)
    if not np.issubdtype(codes.dtype, np.integer):
        rounded = np.rint(codes)
        if not np.array_equal(rounded, codes):
            raise ValueError(
                "as_factor needs integer-valued labels; got non-integer "
                "values (bin or hash continuous features first)")
        codes = rounded
    codes = codes.astype(np.int64)
    if codes.size and codes.min() < 0:
        raise ValueError("as_factor: negative label codes")
    if num_levels is None:
        num_levels = int(codes.max()) + 1 if codes.size else 1
    elif codes.size and codes.max() >= num_levels:
        raise ValueError(
            f"as_factor: label code {int(codes.max())} out of range for "
            f"num_levels={num_levels}")
    return Factor(codes, num_levels)


def one_hot(*factors, dtype=np.float32, host: bool = True) -> FM:
    """One-hot encode factor(s) into ONE sparse matrix (the ELL tier): k
    factors cbind with running column offsets, so every row has exactly k
    ones.  ``host=True``, the default, places the slab in host RAM (numpy
    ``cols`` / ``vals``, streamed out of core a partition at a time);
    ``host=False`` builds it on the engine's device.  Like ``conv_R2FM``,
    it raises when the engine's device is a CUDA device and no card is
    present, whichever tier is asked for."""
    from ..storage import registry  # deferred: storage imports core
    registry.device()
    if not factors:
        raise ValueError("one_hot needs at least one factor")
    fs = [as_factor(f) for f in factors]
    n = len(fs[0])
    if any(len(f) != n for f in fs):
        raise ValueError(
            f"one_hot: factor lengths differ ({[len(f) for f in fs]})")
    ncol, offset = 0, []
    for f in fs:
        offset.append(ncol)
        ncol += f.num_levels
    cols = np.stack([f.codes + off for f, off in zip(fs, offset)],
                    axis=1).astype(np.int32)
    if host:
        # host staging type of the dtype (bf16 as float32, as in conv_R2FM)
        vals = np.ones(cols.shape, dtypes.np_equiv(dtypes.canon(dtype)))
    else:
        cols = matrix_mod.to_device(cols)
        vals = torch.ones(cols.shape, dtype=dtypes.canon(dtype),
                          device=cols.device)
    from ..storage.sparse import SparseEllStore  # deferred: storage imports core
    store = SparseEllStore(cols, vals, ncol, nnz=n * len(fs))
    return FM(FMMatrix((n, ncol), dtypes.canon(dtype), store=store))


def materialize(*xs, **kw) -> list[FM]:
    """fm.materialize: fused evaluation of every argument in one pass."""
    mats = mat_mod.materialize(*[_fm(x) for x in xs], **kw)
    return [FM(m) for m in mats]


def batch(*request_groups, **kw):
    """fm.batch: cross-materialize stream fusion (core/batch.py).

    Each argument is one request — a lazy matrix, or a tuple/list of lazy
    matrices that would otherwise be one ``fm.materialize(...)`` call.
    Every request keeps its own plan, but requests whose passes stream the
    same physical sources are co-scheduled onto one partition sweep: k
    plans × 1 stream (``fm.exec_stats()['streams']``).

        means, (sds, ctp) = fm.batch(fm.colMeans(X),
                                     (fm.colSds(X), fm.crossprod(X)))

    With no arguments, returns a collector to queue requests explicitly:

        with fm.batch() as b:
            h = b.add(fm.colMeans(X))
        h.value

    Keywords (``mode``, ``backend``, ``donate``, ``prefetch``,
    ``reuse_plans``, ``mesh``) follow ``fm.materialize``; ``mode='auto'``
    picks per group from the union of that group's sources."""
    from . import batch as batch_mod
    b = batch_mod.Batch(**kw)
    if not request_groups:
        return b
    handles = []
    for grp in request_groups:
        outs = grp if isinstance(grp, (tuple, list)) else (grp,)
        handles.append(b.add(*[_fm(x) for x in outs]))
    b.run()
    results = []
    for grp, h in zip(request_groups, handles):
        v = h.value
        results.append([FM(m) for m in v] if isinstance(v, list) else FM(v))
    return results


def serve(**kw):
    """fm.serve: start an async multi-tenant serving `Engine`
    (core/serve.py) — concurrent threads ``submit()`` lazy requests, a
    short admission window groups strangers' plans by shared sources, and
    each group streams its matrices ONCE for all members (k requests ×
    1 stream), with bandwidth admission control and mid-stream admission
    of late same-group plans.

        with fm.serve(window_ms=5) as eng:
            h1 = eng.submit(fm.colMeans(X))   # any thread
            h2 = eng.submit(fm.crossprod(X))  # same window, same stream
            mu, G = h1.result(), h2.result()

    Keywords are `Engine`'s (window_ms, max_window_requests,
    max_concurrent_streams, max_inflight_bytes, bandwidth_window_s,
    max_pending_requests, submit_timeout_s, midstream_admission, mode,
    backend, donate, prefetch, prefetch_depth, reuse_plans, mesh)."""
    from . import serve as serve_mod
    return serve_mod.Engine(**kw)


def __getattr__(name):
    # fm.Engine without importing the serving layer at fm import time.
    if name in ("Engine", "EngineSaturated"):
        from . import serve as serve_mod
        return getattr(serve_mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def explain(*xs, backend: Optional[str] = None) -> str:
    """fm.explain: render the fused plan ``fm.materialize(*xs)`` would run
    — pass schedule, source tiers, both partition levels, per-segment
    backend dispatch — without executing anything."""
    from ..observability.explain import explain as _explain
    return _explain(*[_fm(x) for x in xs], backend=backend)


def explain_batch(*request_groups, backend: Optional[str] = None) -> str:
    """fm.explain_batch: render the co-schedule ``fm.batch(*requests)``
    would run — per round, the stream groups with their member plans,
    shared sources and the union bytes one drive reads — without executing
    anything.  Arguments mirror ``fm.batch``: each one is a lazy matrix or
    a tuple/list of them forming one request."""
    from ..observability.explain import explain_batch as _explain_batch
    groups = [grp if isinstance(grp, (tuple, list)) else (grp,)
              for grp in request_groups]
    return _explain_batch([[_fm(x) for x in g] for g in groups],
                          backend=backend)


def inspect_iterations():
    """fm.inspect_iterations: declare an iterative driver's loop."""
    return mat_mod.iteration_scope()


def as_scalar(x) -> float:
    (r,) = materialize(x) if _fm(x).is_virtual else (x,)
    return float(conv_FM2R(r).reshape(()))


def as_np(x) -> np.ndarray:
    return conv_FM2R(x)


# -- observability ---------------------------------------------------------

def trace(export: Optional[str] = None, *, reset: bool = True):
    """fm.trace: enable span tracing over a with-block; device steps
    synchronize only while it is on."""
    from ..observability.trace import TRACER
    return TRACER.recording(export, reset=reset)


def trace_export(path) -> str:
    from ..observability.trace import TRACER
    return TRACER.export(path)


def trace_events() -> list:
    from ..observability.trace import TRACER
    return TRACER.events()


def collect_stats(name: str = ""):
    """fm.collect.stats: a metrics scope isolating this thread's activity."""
    from ..observability import metrics
    return metrics.collect(name)


def exec_stats() -> dict:
    """fm.exec.stats: the engine's execution counters."""
    return mat_mod.exec_stats()


def reset_exec_stats():
    mat_mod.reset_exec_stats()
