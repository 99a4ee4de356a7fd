"""Twin of tests/test_archs.py's rows for the ported families (dense, MoE,
VLM, SSM, hybrid, enc-dec): each ported architecture at its reduced config runs one
forward and one gradient on the CPU — a finite scalar loss, a gradient of
every leaf's shape, all finite (a zero-length leaf, the reduced hybrid's
empty tail, has no element to check) — and ``input_specs`` covers every
shape of the full config (train, prefill, decode, and ``long_500k`` for
the SSM and hybrid) as the reference's does, the VLM's patch embeddings
and the enc-dec's frames in ``cfg.dtype``; the full configs' parameter
trees on the ``meta`` device (nothing allocated) count within 2× of
``n_params``, and the published sizes hold (``test_param_counts_sane``).
The serving row (``test_prefill_decode_matches_forward``) is twinned in
tests/test_torch_lm.py.
"""
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import input_specs as jinput_specs
from repro_torch.configs import PORTED_IDS, get_config, reduced_for_smoke
from repro_torch.models import zoo
from repro_torch.models.layers import dtype_of

RNG = np.random.default_rng(0)


@pytest.mark.parametrize("arch", PORTED_IDS)
def test_forward_and_train_shapes(arch):
    cfg = reduced_for_smoke(get_config(arch))
    model = zoo.build(cfg, device="cpu")
    params = model.init(0)
    batch = {k: torch.from_numpy(RNG.integers(0, cfg.vocab, (2, 64))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    if cfg.family == "vlm":
        batch["patch_embs"] = torch.from_numpy(RNG.normal(
            size=(2, cfg.n_patches, cfg.d_model)).astype(np.float32))
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(RNG.normal(
            size=(2, cfg.enc_len, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        loss, metrics = model.forward(params, batch)
    assert loss.shape == () and np.isfinite(float(loss))
    assert set(metrics) == {"loss"}
    for _, p in zoo.flatten(params):
        p.requires_grad_(True)
    model.forward(params, batch)[0].backward()
    for name, p in zoo.flatten(params):
        if p.numel() == 0:      # the loss cannot read an empty leaf
            continue
        assert p.grad is not None and p.grad.shape == p.shape, name
        assert torch.isfinite(p.grad).all(), name


@pytest.mark.parametrize("arch", PORTED_IDS)
def test_input_specs_cover_all_shapes(arch):
    cfg = get_config(arch)
    shapes = cfg.shapes()
    assert ("long_500k" in shapes) == cfg.supports_long_context
    assert set(shapes) == set(jget_config(arch).shapes())
    for name, sh in shapes.items():
        spec = zoo.input_specs(cfg, sh)
        want = jinput_specs(jget_config(arch), sh)
        assert spec["kind"] == want["kind"] in ("train", "prefill", "decode")
        assert set(spec["batch"]) == set(want["batch"])
        for k, v in spec["batch"].items():
            assert all(d > 0 for d in v.shape), (arch, name, k)
            assert tuple(v.shape) == want["batch"][k].shape
            assert str(v.dtype) == f"torch.{want['batch'][k].dtype}"
            assert v.dtype == (dtype_of(cfg.dtype)
                               if k in ("patch_embs", "frames")
                               else torch.int32)
            assert v.device.type == "meta"


@pytest.mark.parametrize("arch", ["qwen2-72b", "arctic-480b",
                                  "qwen3-moe-30b-a3b", "paligemma-3b",
                                  "mamba2-1.3b", "zamba2-7b",
                                  "whisper-medium"])
def test_full_config_abstract_params(arch):
    """FULL configs as ``meta`` tensors only — no allocation."""
    cfg = get_config(arch)
    tree = zoo.module_for(cfg).init(cfg, None)
    leaves = [t for _, t in zoo.flatten(tree)]
    assert {t.device.type for t in leaves} == {"meta"}
    assert {t.dtype for t in leaves} == {dtype_of(cfg.param_dtype)}
    n = sum(t.numel() for t in leaves)
    assert 0.5 < n / cfg.n_params() < 2.0, (arch, n, cfg.n_params())


def test_param_counts_sane():
    """The published sizes: ``n_params`` and the meta tree's count of each
    ported config, and qwen3-moe's ~3.3B active a token.  mamba2-1.3b's
    and whisper-medium's targets are the reference test's 1.3e9 and
    0.76e9; zamba2-7b's is its own ``n_params``, 6.75e9 (the reference
    test has no row for it)."""
    expected = {"qwen2-72b": 72e9, "granite-8b": 8e9, "llama3.2-3b": 3.2e9,
                "qwen2-0.5b": 0.5e9, "arctic-480b": 480e9,
                "qwen3-moe-30b-a3b": 30.5e9, "paligemma-3b": 2.9e9,
                "mamba2-1.3b": 1.3e9, "zamba2-7b": 6.75e9,
                "whisper-medium": 0.76e9}
    assert set(expected) == set(PORTED_IDS)
    for arch, target in expected.items():
        cfg = get_config(arch)
        n = sum(t.numel() for _, t in
                zoo.flatten(zoo.module_for(cfg).init(cfg, None)))
        for count in (cfg.n_params(), n):
            assert 0.5 < count / target < 1.7, (arch, count / 1e9)
    qwen = get_config("qwen3-moe-30b-a3b")
    assert 0.5 < qwen.n_active_params() / 3.3e9 < 1.7
