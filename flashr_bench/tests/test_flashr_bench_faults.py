"""The comparison that decides ``correct``, driven at a tiny size on the
CPU: a sound run of the cell comes out correct; the same run with the timed
path broken underneath, once for each fault the cell can have, and the
control (the reference at TF32 operands in the program's place) come out
not correct.  The cell runs on one card, so no fault leaves out an exchange
between cards."""
import importlib
import json

import pytest
import torch

from flashr_bench_tiny import CELL, SEED, TINY_ROWS, tiny_calls, tiny_run

from flashr_bench import calibrate, loops, manifest  # noqa: E402


def _steps(mp, broken):
    """Patch kmeans' iteration: ``broken(step)`` says whether the step
    (1, 2, ... of each call) hands back the centres it was given."""
    km = importlib.import_module("repro_torch.algorithms.kmeans")
    init, orig = km._init_centers, km.kmeans_iteration
    step = [0]

    def fresh_init(*a, **kw):
        step[0] = 0
        return init(*a, **kw)

    def iteration(X, centers, **kw):
        step[0] += 1
        new, counts, wss, labels = orig(X, centers, **kw)
        return (centers if broken(step[0]) else new), counts, wss, labels
    mp.setattr(km, "_init_centers", fresh_init)
    mp.setattr(km, "kmeans_iteration", iteration)


def state_unchanged(mp):
    """Every step hands back the state it was given."""
    _steps(mp, lambda step: True)


def state_unchanged_at_one_step(mp):
    """The third of kmeans' five steps hands back the state it was given;
    the others are sound."""
    _steps(mp, lambda step: step == 3)


def one_step_reported_as_all(mp):
    """kmeans runs one Lloyd step and reports ``max_iter``."""
    import repro_torch.algorithms as algos
    km = importlib.import_module("repro_torch.algorithms.kmeans")
    orig = km.kmeans

    def kmeans(*a, max_iter=20, **kw):
        res = orig(*a, **{**kw, "max_iter": 1})
        res.iters = max_iter
        return res
    mp.setattr(algos, "kmeans", kmeans)


def half_left_out(mp):
    """The program is handed the first half of the rows: every mean and sum
    is taken over the rest."""
    orig = loops.place

    def half(fm, torch_, data, mix, device):
        n = data["X"].shape[0] // 2
        return orig(fm, torch_, {k: v[:n] for k, v in data.items()}, mix,
                    device)
    mp.setattr(loops, "place", half)


def answer_altered(mp):
    """One answer altered where the program produces it."""
    import repro_torch.algorithms as algos
    orig = algos.correlation

    def correlation(*a, **kw):
        c = orig(*a, **kw).copy()
        c[0, 1] += 1e-3
        c[1, 0] += 1e-3
        return c
    mp.setattr(algos, "correlation", correlation)


FAULTS = {f.__name__: f for f in (
    state_unchanged, state_unchanged_at_one_step, one_step_reported_as_all,
    half_left_out, answer_altered)}


def _why(out):
    return {k: v for k, v in out["checks"].items()
            if not v["value"] <= v["limit"]}


def test_a_sound_run_is_correct():
    out = tiny_run()
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["correct"], _why(out)
    assert set(out["checks"]) == set(manifest.traffic("suite")["limits"])


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_broken_run_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = tiny_run()
    assert not out["correct"]
    assert _why(out) or out["failed"]


@pytest.mark.parametrize("fault", ["state_unchanged_at_one_step",
                                   "one_step_reported_as_all"])
def test_a_kmeans_fault_fails_a_kmeans_number(fault, monkeypatch):
    """Caught by the steps read after the window, not by the window's own
    answer: the final centres are still the means under the final labels."""
    FAULTS[fault](monkeypatch)
    why = _why(tiny_run())
    assert {"kmeans.label_gap", "kmeans.update"} & set(why), why


def test_the_control_is_not_correct():
    out = calibrate.control(CELL, SEED, torch.device("cpu"),
                            manifest.load(), cfg_over={"rows": TINY_ROWS},
                            mix_over={"calls": tiny_calls()})
    failing = {k: v for k, v in out["checks"].items()
               if not v <= out["limits"][k]}
    assert failing, json.dumps(out["checks"])
