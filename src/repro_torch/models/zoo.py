"""Model zoo: the facade over the ported architecture families — the port
of repro/models/zoo.py for the dense, MoE, VLM, SSM, hybrid and enc-dec
families.

``build(cfg)`` returns a ``Model`` whose functions share the reference's
signatures:

    init(gen)                                   -> params
    abstract_params()                           -> (meta params, axes)
    cache_axes()                                -> the cache's axes tree
    abstract_cache(batch, max_len)              -> meta cache
    forward(params, batch)                      -> (loss, metrics)
    prefill(params, batch, max_len)             -> (cache, logits)
    decode(params, cache, token)                -> (cache, logits)
    init_cache(batch, max_len)                  -> cache

on the model's device: ``cuda`` unless the caller asks for the CPU (the
``device`` argument, else the engine's ``device`` knob, ``fm.set_conf(device=
...)``); with no card and no such request, ``build`` raises.  A VLM's
batch carries ``patch_embs`` (B, n_patches, d_model) beside its tokens, an
enc-dec's ``frames`` (B, enc_len, d_model).  Each family's functions come
from its module (``MODULES``): dense, MoE and VLM from ``transformer``, SSM
from ``ssm_lm``, hybrid from ``hybrid``, enc-dec from ``encdec``.
``params_from_numpy`` and ``opt_state_from_numpy`` carry a JAX parameter
tree and AdamW state across, so both packages compute the same thing.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs.base import ArchConfig, ShapeSpec
from . import encdec, hybrid, ssm_lm, transformer
from .base import axes_of
from .layers import dtype_of

#: The module that computes each family ``build`` serves.
MODULES = {**{f: transformer for f in transformer.FAMILIES},
           **{f: ssm_lm for f in ssm_lm.FAMILIES},
           **{f: hybrid for f in hybrid.FAMILIES},
           **{f: encdec for f in encdec.FAMILIES}}
#: Families ``build`` serves.
FAMILIES = tuple(MODULES)


def module_for(cfg: ArchConfig):
    """The module computing ``cfg.family``; an unknown family raises."""
    if cfg.family not in MODULES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}; the "
                         f"port serves {FAMILIES}")
    return MODULES[cfg.family]


def resolve_device(device=None) -> torch.device:
    """``device`` if given, else the engine's device knob; a CUDA device with
    no card raises (nothing falls back to the CPU unasked)."""
    if device is None:
        from ..storage import registry
        return registry.device()
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} was asked for and torch.cuda.is_available() is "
            "False; ask for the CPU with device='cpu'")
    return dev


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    device: torch.device

    @property
    def module(self):
        return module_for(self.cfg)

    def init(self, gen) -> dict:
        """Parameters drawn from ``gen``: a ``torch.Generator`` on the
        model's device, or an int seed for one."""
        if isinstance(gen, int):
            seed, gen = gen, torch.Generator(device=self.device)
            gen.manual_seed(seed)
        if gen.device.type != self.device.type:
            raise ValueError(f"generator on {gen.device}, model on "
                             f"{self.device}")
        return self.module.init(self.cfg, gen)

    def abstract_params(self):
        """(tree of ``meta`` tensors, tree of '|'-joined logical axes)
        without allocating: the twin of the reference's
        ``Model.abstract_params`` (its ShapeDtypeStruct tree and
        ``tree_unbox`` axes)."""
        shapes = self.module.init(self.cfg, None)
        return shapes, tree_map(lambda _, t: axes_of(t), shapes)

    def cache_axes(self) -> dict:
        """The logical axes of ``init_cache``'s tree: the twin of the
        reference's ``Model.cache_axes``."""
        return self.module.cache_axes(self.cfg)

    def abstract_cache(self, batch: int, max_len: int) -> dict:
        """``init_cache``'s tree as ``meta`` tensors, allocating nothing:
        the twin of the reference's ``abstract_cache`` (an enc-dec's
        cross K/V at ``cfg.enc_len``)."""
        return self.module.init_cache(self.cfg, batch, max_len, "meta")

    def prefill(self, params, batch: dict, max_len: int, *,
                attn_impl: str = "auto", cache=None):
        """``attn_impl`` picks the attention of the families that attend
        in a prefill (the SSM ignores it).  An enc-dec prefill encodes
        ``batch["frames"]`` first, as the reference's ``build`` passes
        them.  ``cache`` is the cache to fill (the family's
        ``prefill``)."""
        if self.cfg.family == "encdec":
            return self.module.prefill(self.cfg, params, batch["frames"],
                                       batch["tokens"], max_len,
                                       attn_impl=attn_impl, cache=cache)
        return self.module.prefill(self.cfg, params, batch["tokens"],
                                   max_len, patch_embs=batch.get("patch_embs"),
                                   attn_impl=attn_impl, cache=cache)

    def decode(self, params, cache, token):
        return self.module.decode(self.cfg, params, cache, token)

    def init_cache(self, batch: int, max_len: int) -> dict:
        return self.module.init_cache(self.cfg, batch, max_len, self.device)

    def forward(self, params, batch, **kw):
        return self.module.forward(self.cfg, params, batch, **kw)


def build(cfg: ArchConfig, device=None) -> Model:
    module_for(cfg)
    return Model(cfg, resolve_device(device))


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """Meta-device stand-ins for one (arch × shape) cell's inputs: train
    takes tokens and labels (B, S), prefill tokens (B, S) with max_len S,
    decode one token (B, 1) against a cache of max_len S.  A VLM's S
    counts its patches: tokens and labels are (B, S - n_patches), beside
    ``patch_embs`` (B, n_patches, d_model) in ``cfg.dtype``; an enc-dec's
    tokens and labels (B, S) beside ``frames`` (B, enc_len, d_model) in
    ``cfg.dtype``.  The SSM and hybrid take the dense family's inputs,
    ``long_500k``'s too.  ``axes`` holds each input's logical axes, the
    reference's."""
    B, S = shape.global_batch, shape.seq_len
    module_for(cfg)

    def tok(shape_):
        return torch.empty(shape_, dtype=torch.int32, device="meta")

    text = S - cfg.n_patches                    # n_patches is 0 but for VLM
    batch = {"tokens": tok((B, text)), "labels": tok((B, text))}
    axes = {"tokens": "batch|seq", "labels": "batch|seq"}
    if cfg.family == "vlm":
        batch["patch_embs"] = torch.empty(
            (B, cfg.n_patches, cfg.d_model), dtype=dtype_of(cfg.dtype),
            device="meta")
        axes["patch_embs"] = "batch|seq|embed"
    if cfg.family == "encdec":
        batch["frames"] = torch.empty(
            (B, cfg.enc_len, cfg.d_model), dtype=dtype_of(cfg.dtype),
            device="meta")
        axes["frames"] = "batch|seq|embed"
    if shape.kind == "train":
        return {"kind": "train", "batch": batch, "axes": axes}
    if shape.kind == "prefill":
        del batch["labels"], axes["labels"]
        return {"kind": "prefill", "batch": batch, "axes": axes,
                "max_len": S}
    if shape.kind == "decode":
        return {"kind": "decode", "batch": {"token": tok((B, 1))},
                "axes": {"token": "batch|seq"}, "max_len": S,
                "cache_batch": B}
    raise ValueError(f"unknown shape kind {shape.kind!r}")


def flatten(tree, prefix=""):
    """(dotted name, leaf) of every leaf of a parameter tree."""
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from flatten(v, name + ".")
        else:
            yield name, v


def params_from_numpy(cfg: ArchConfig, tree: dict, device=None) -> dict:
    """The port's parameters from the reference's tree as numpy arrays
    (``tree_unbox(model.init(key))[0]`` mapped through ``np.asarray``): the
    same keys, the same (in, out) layouts and the same stacked layer axis,
    each leaf checked against the port's shape and cast to
    ``cfg.param_dtype`` on ``device``.  The expected tree is the family's
    own ``init``'s; zero-length leaves (a hybrid's empty tail) carry over
    as such."""
    dev = resolve_device(device)
    want = dict(flatten(module_for(cfg).init(cfg, None)))
    got = dict(flatten(tree))
    if set(got) != set(want):
        raise ValueError(f"parameter tree keys differ: missing "
                         f"{sorted(set(want) - set(got))}, unexpected "
                         f"{sorted(set(got) - set(want))}")

    def leaf(name, a):
        a = np.asarray(a)
        if tuple(a.shape) != tuple(want[name].shape):
            raise ValueError(f"{name}: shape {a.shape}, expected "
                             f"{tuple(want[name].shape)}")
        if a.dtype.name == "bfloat16":          # ml_dtypes: via float32
            a = a.astype(np.float32)
        return torch.from_numpy(np.array(a)).to(
            device=dev, dtype=dtype_of(cfg.param_dtype))

    return tree_map(leaf, tree)


def opt_state_from_numpy(cfg: ArchConfig, state: dict, device=None) -> dict:
    """The port's AdamW state from the reference's ``{"m", "v", "step"}``
    as numpy arrays: the moment trees checked as ``params_from_numpy``
    checks parameters, in their own dtype (bf16 or f32 moments), the step
    a 0-d int32 tensor."""
    dev = resolve_device(device)
    first = np.asarray(next(v for _, v in flatten(state["m"])))
    mcfg = dataclasses.replace(cfg, param_dtype=first.dtype.name)
    return {"m": params_from_numpy(mcfg, state["m"], dev),
            "v": params_from_numpy(mcfg, state["v"], dev),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=dev)}


def tree_map(fn, tree, prefix=""):
    """The tree with every leaf replaced by fn(dotted name, leaf)."""
    return {k: tree_map(fn, v, f"{prefix}{k}.") if isinstance(v, dict)
            else fn(f"{prefix}{k}", v) for k, v in tree.items()}
