"""Atomic, async checkpoints in the reference's on-disk format — the port
of repro/checkpoint/checkpoint.py.

* **Atomic**: a step is written to ``step_<n>.tmp/`` and renamed to
  ``step_<n>`` (the commit point); a reader only ever sees complete steps.
* **Async**: the device→host copy happens in ``save``, so the caller may
  update the tensors right after it returns; the disk write runs on a
  thread unless ``blocking``.
* **Format**, byte for byte the reference's, so each package restores the
  other's checkpoints: one ``np.save`` file per leaf, ``leaf_<i>.npy`` in
  the order JAX flattens the tree (dict keys sorted at every level), a
  bfloat16 leaf stored as its uint16 payload with ``"dtype": "bfloat16"``
  in the manifest; a CRC-32 per file, ``manifest.json`` (leaf keys are the
  dict keys joined by ``/``, as ``params/layers/attn/wq``) and a
  ``latest`` pointer.
* **Restore** places each leaf on its template's device, in its
  template's dtype.  The reference's elastic restore onto new shardings
  waits for the sharded train step (ROADMAP A14).
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch


def _flatten_with_paths(tree, prefix=""):
    """(key, leaf) in JAX's order for a tree of dicts."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += _flatten_with_paths(v, f"{prefix}{k}/")
        else:
            out.append((f"{prefix}{k}", v))
    return out


def _unflatten(template, values, prefix=""):
    return {k: _unflatten(v, values, f"{prefix}{k}/") if isinstance(v, dict)
            else values[f"{prefix}{k}"] for k, v in template.items()}


def _to_host(v):
    """(numpy array as written, logical dtype name) of one leaf: a copy,
    so the caller may update the tensor once ``save`` returns."""
    if isinstance(v, torch.Tensor):
        t = v.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.array(v)
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, logical: str, tmpl: torch.Tensor):
    if logical == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=tmpl.device, dtype=tmpl.dtype)


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # -- save ------------------------------------------------------------------
    def save(self, step: int, tree: Any, *, extra: Optional[dict] = None,
             blocking: bool = False):
        """Snapshot ``tree`` at ``step``.  The device→host copy happens
        here; the disk write on a background thread unless blocking."""
        self.wait()  # at most one in-flight save
        host = [(k,) + _to_host(v) for k, v in _flatten_with_paths(tree)]

        def write():
            tmp = self.dir / f"step_{step:010d}.tmp"
            final = self.dir / f"step_{step:010d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            manifest = {"step": step, "extra": extra or {}, "leaves": {}}
            for i, (key, arr, logical_dtype) in enumerate(host):
                fname = f"leaf_{i:05d}.npy"
                with open(tmp / fname, "wb") as f:
                    np.save(f, arr)
                    f.flush()
                crc = zlib.crc32((tmp / fname).read_bytes()) & 0xFFFFFFFF
                manifest["leaves"][key] = {
                    "file": fname, "shape": list(arr.shape),
                    "dtype": logical_dtype, "crc32": crc,
                }
            (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)                      # the atomic commit point
            (self.dir / "latest.tmp").write_text(str(step))
            (self.dir / "latest.tmp").rename(self.dir / "latest")
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True,
                                            name="ckpt-write")
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # -- restore ---------------------------------------------------------------
    def all_steps(self):
        return [int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                if p.is_dir() and not p.name.endswith(".tmp")]

    def latest_step(self) -> Optional[int]:
        ptr = self.dir / "latest"
        if ptr.exists():
            s = int(ptr.read_text())
            if (self.dir / f"step_{s:010d}" / "manifest.json").exists():
                return s
        steps = self.all_steps()
        return max(steps) if steps else None

    def restore(self, template: Any, *, step: Optional[int] = None,
                verify: bool = True):
        """Load into the structure of ``template`` (a tree of tensors):
        each leaf on its template leaf's device and in its dtype.  Returns
        (tree, step, extra)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        d = self.dir / f"step_{step:010d}"
        manifest = json.loads((d / "manifest.json").read_text())
        values = {}
        for key, tmpl in _flatten_with_paths(template):
            meta = manifest["leaves"].get(key)
            if meta is None:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            raw = (d / meta["file"]).read_bytes()
            if verify:
                crc = zlib.crc32(raw) & 0xFFFFFFFF
                if crc != meta["crc32"]:
                    raise IOError(f"CRC mismatch for {key} in step {step}")
            arr = np.load(d / meta["file"])
            values[key] = _from_host(arr, meta["dtype"], tmpl)
        return _unflatten(template, values), step, manifest.get("extra", {})
