"""Architecture configuration schema + assigned input shapes.

One ``ArchConfig`` per assigned architecture lives in
``src/repro/configs/<id>.py`` with the exact published numbers; every config
also provides ``reduced()`` — the same family scaled down for CPU smoke
tests (small layers/width, few experts, tiny vocab), per the assignment.

The four assigned input-shape sets are global (LM-family):

    train_4k     seq 4096  × global_batch 256   (train_step)
    prefill_32k  seq 32768 × global_batch 32    (serve_step, prefill)
    decode_32k   seq 32768 × global_batch 128   (serve_step, 1 new token)
    long_500k    seq 524288 × global_batch 1    (sub-quadratic only)
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 => d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    act: str = "swiglu"            # swiglu | geglu | gelu
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0              # expert hidden (defaults to d_ff)
    dense_residual: bool = False   # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_ngroups: int = 1

    # hybrid (zamba2): one shared attention block applied every N ssm layers
    shared_attn_every: int = 0

    # enc-dec (whisper)
    n_enc_layers: int = 0
    enc_len: int = 1500            # fixed audio frame count (stub frontend)

    # vlm (paligemma)
    n_patches: int = 0             # prepended image patch embeddings (stub)

    # distribution/runtime knobs
    dtype: str = "bfloat16"        # compute/activation dtype
    param_dtype: str = "float32"   # master weights
    remat: bool = True             # activation checkpointing per layer
    scan_layers: bool = True
    grad_accum: int = 1            # microbatches per train step
    seq_parallel: bool = True      # shard the residual-stream carry on seq
    # Serve-time weights-resident mode (replicate params over `data`): zero
    # steady-state weight traffic per decoded token.  Off for models whose
    # bf16 weights exceed per-device HBM when sharded on `model` alone
    # (arctic-480b: 960 GB / 16 = 60 GB) — those keep FSDP sharding and pay
    # the per-token gather instead.
    serve_weights_resident: bool = True

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """long_500k runs only for sub-quadratic families (DESIGN.md §3)."""
        return self.family in ("ssm", "hybrid")

    @property
    def moe_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def shapes(self):
        out = {}
        for name, s in SHAPES.items():
            if name == "long_500k" and not self.supports_long_context:
                continue
            out[name] = s
        return out

    def n_params(self) -> float:
        """Approximate parameter count (for 6ND roofline math)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd, nh, nkv = self.hd, self.n_heads, self.n_kv_heads
        attn = (d * (nh * hd) + 2 * d * (nkv * hd) + (nh * hd) * d
                if nh else 0)
        glu = 3 if self.act in ("swiglu", "geglu") else 2
        per_layer = 0.0
        if self.family == "ssm":
            per_layer = _ssm_params(self)
        else:
            per_layer += attn
            if self.n_experts:
                per_layer += self.n_experts * glu * d * self.moe_ff + d * self.n_experts
                if self.dense_residual:
                    per_layer += glu * d * f
            else:
                per_layer += glu * d * f
        total = self.n_layers * per_layer
        if self.family == "hybrid":
            n_apps = self.n_layers // max(1, self.shared_attn_every)
            total = self.n_layers * _ssm_params(self) + (attn + glu * d * f)
            del n_apps  # weights shared: count once
        if self.family == "encdec":
            enc = self.n_enc_layers * (attn + 2 * d * f)
            dec = self.n_layers * (2 * attn + 2 * d * f)
            total = enc + dec
        emb = v * d * (1 if self.tie_embeddings else 2)
        return float(total + emb)

    def n_active_params(self) -> float:
        """Active-per-token params (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.n_params()
        d = self.d_model
        glu = 3 if self.act in ("swiglu", "geglu") else 2
        full_moe = self.n_layers * self.n_experts * glu * d * self.moe_ff
        active_moe = self.n_layers * self.top_k * glu * d * self.moe_ff
        return self.n_params() - full_moe + active_moe


def _ssm_params(cfg: ArchConfig) -> float:
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    nheads = d_in // cfg.ssm_headdim
    n = cfg.ssm_state
    proj_in = d * (2 * d_in + 2 * cfg.ssm_ngroups * n + nheads)
    conv = (d_in + 2 * cfg.ssm_ngroups * n) * cfg.ssm_conv
    return proj_in + conv + 3 * nheads + d_in + d_in * d


def reduced_for_smoke(cfg: ArchConfig) -> ArchConfig:
    """Shrink a config to CPU-smoke scale, preserving the family structure."""
    return dataclasses.replace(
        cfg,
        n_layers=min(cfg.n_layers, 2),
        n_enc_layers=min(cfg.n_enc_layers, 2) if cfg.n_enc_layers else 0,
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=256,
        moe_d_ff=64 if cfg.n_experts else 0,
        vocab=512,
        n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_headdim=32 if cfg.ssm_state else 64,
        shared_attn_every=2 if cfg.shared_attn_every else 0,
        enc_len=32 if cfg.family == "encdec" else cfg.enc_len,
        n_patches=8 if cfg.n_patches else 0,
        dtype="float32",
        param_dtype="float32",
        remat=False,
    )
