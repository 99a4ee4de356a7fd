"""Twin of tests/test_archs.py's dense rows: each ported (dense)
architecture at its reduced config runs one forward and one gradient on
the CPU — a finite scalar loss, a gradient of every leaf's shape, all
finite — and ``input_specs`` covers every shape of the full config (train,
prefill, decode) as the reference's does.  The serving row
(``test_prefill_decode_matches_forward``) is twinned in
tests/test_torch_lm.py; the other families' rows wait for ROADMAP A14.
"""
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import input_specs as jinput_specs
from repro_torch.configs import PORTED_IDS, get_config, reduced_for_smoke
from repro_torch.models import zoo

RNG = np.random.default_rng(0)


@pytest.mark.parametrize("arch", PORTED_IDS)
def test_forward_and_train_shapes(arch):
    cfg = reduced_for_smoke(get_config(arch))
    model = zoo.build(cfg, device="cpu")
    params = model.init(0)
    batch = {k: torch.from_numpy(RNG.integers(0, cfg.vocab, (2, 64))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    with torch.no_grad():
        loss, metrics = model.forward(params, batch)
    assert loss.shape == () and np.isfinite(float(loss))
    assert set(metrics) == {"loss"}
    for _, p in zoo.flatten(params):
        p.requires_grad_(True)
    model.forward(params, batch)[0].backward()
    for name, p in zoo.flatten(params):
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
            assert v.dtype == torch.int32 and v.device.type == "meta"
