"""Build and load the hand-written Hopper kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds).  The first call that needs a kernel builds every source —
one ``nvcc`` per source, all started together — into ``_build/`` beside this
file, under names keyed by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds and
concurrent processes share one build (a file lock serializes them).  No
``nvcc``, or a failed build, raises: nothing falls back.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
SOURCES = ("gram", "fused_apply_agg", "kmeans_assign", "spmm",
           "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


class KernelBuildError(RuntimeError):
    pass


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise KernelBuildError(
            "nvcc not found: the CUDA kernels are built from "
            f"{CSRC} on first use and need the CUDA toolkit")
    return path


def _digest(name: str) -> str:
    """Hash of ``<name>.cu``, every shared header ``csrc/*.cuh`` (a source
    may include any of them) and the flags: an edit to any rebuilds."""
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def lib_path(name: str) -> pathlib.Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build_all() -> float:
    """Build every missing library, all ``nvcc`` processes at once; returns
    the seconds spent (0.0 when everything was built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        todo = [s for s in SOURCES if not lib_path(s).exists()]
        if not todo:
            return 0.0
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = []
        for name in todo:
            tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs.append((name, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors = []
        for name, tmp, proc in procs:
            out, _ = proc.communicate()
            (BUILD_DIR / f"{name}.log").write_bytes(out)
            if proc.returncode != 0:
                errors.append(f"{name}.cu (nvcc exit {proc.returncode}):\n"
                              + out.decode(errors="replace")[-4000:])
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, lib_path(name))
        if errors:
            raise KernelBuildError("kernel build failed:\n" + "\n".join(errors))
        return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if not lib_path(name).exists():
                build_all()
            lib = ctypes.CDLL(str(lib_path(name)))
            _declare(lib)
            _LIBS[name] = lib
        return lib


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float

_SIGNATURES = {
    "fm_gram": (_P, _P, _P, _L, _I, _L, _I, _P),
    "fm_wgram": (_P, _P, _P, _P, _L, _I, _L, _I, _P),
    # x, w, ws, out, n, p, R, stages, rows_per_split, splits, dtype, stream
    "fm_wgram_tri": (_P, _P, _P, _P, _L, _I, _I, _I, _L, _L, _I, _P),
    # x, ws, out, n, p, R, stages, rows_per_split, splits, dtype, stream
    "fm_gram_tri": (_P, _P, _P, _L, _I, _I, _I, _L, _L, _I, _P),
    "fm_xty": (_P, _P, _P, _P, _L, _I, _I, _L, _I, _P),
    # cols, vals, [w], ws, out, n, kmax, ncol, ts, splits, stream
    "fm_spmm_gram": (_P, _P, _P, _P, _L, _I, _I, _I, _L, _P),
    "fm_spmm_wgram": (_P, _P, _P, _P, _P, _L, _I, _I, _I, _L, _P),
    # cols, vals, y, ws, out, n, kmax, ncol, q, qc, cs, warps, splits, stream
    "fm_spmm_xty": (_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _L, _P),
    "fm_fused_apply_agg": (_P, _P, _P, _L, _I, _L, _P, _P),
    # x, ws, out, n, p, R, stages, rows_per_split, splits, prog, stream
    "fm_fused_apply_agg_ring": (_P, _P, _P, _L, _I, _I, _I, _L, _L, _P, _P),
    "fm_kmeans_assign": (_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I,
                         _I, _P),
    # x, c, labels, ws, sums, cnts, wss, n, p, k, blocks, stages, lanes,
    # part_smem, dtype, stream
    "fm_kmeans_assign_tma": (_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I,
                             _I, _I, _I, _P),
    # q, k, v, o, bh, nh, group, S, T, d, scale, causal, dtype, stream
    "fm_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _L, _L, _I, _F, _I, _I,
                           _P),
    "fm_flash_attention_wgmma": (_P, _P, _P, _P, _I, _I, _I, _L, _L, _I, _F,
                                 _I, _P),
}


def _declare(lib: ctypes.CDLL):
    """argtypes/restype of every entry the library has: pointers and the
    stream are c_void_p (64-bit), never the default int."""
    for fn, args in _SIGNATURES.items():
        entry = getattr(lib, fn, None)
        if entry is not None:
            entry.argtypes = list(args)
            entry.restype = ctypes.c_int


def ptxas_report(name: str, function: str) -> list[dict]:
    """Registers and spill bytes of each kernel of ``csrc/<name>.cu`` whose
    mangled name contains ``function``, read from its build log
    (``-Xptxas -v``); [] when the log is missing."""
    log = BUILD_DIR / f"{name}.log"
    if not log.exists():
        return []
    out, cur = [], None
    for line in log.read_text(errors="replace").splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1) if function in m.group(1) else None
            spills = (0, 0)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append({"function": cur, "registers": int(m.group(1)),
                        "spill_stores": spills[0], "spill_loads": spills[1]})
            cur = None
    return out


def check(err: int, what: str):
    """Raise on a non-zero ``cudaError_t`` returned by a C entry."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_handle(t) -> int:
    """The current CUDA stream of the tensor's device, as an integer."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
