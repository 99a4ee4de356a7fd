"""``BENCHMARK.json``: loading, the checks its contract sets, and the files
the harness finds by name.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own, found by the name ``BENCHMARK.json``
gives it:

- ``configs/<config>.json``: the configuration's sizes (the entry's
  ``file``), whose ``kind`` names the generator ``generators/<kind>.py``;
- ``traffic/<mix>.json``: the traffic mix's parameters, read by the one
  general generator in ``loops.py``; each call it makes names an operation
  ``ops/<op>.py``;
- ``metrics/<metric>.py``: the reader of one per-layer metric.

So a later change adds a configuration, a mix, a metric or a cell by adding
files and entries, and edits no file that is here.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import re

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
E2E_SOURCES = {"host_clock", "device_trace"}
SOURCES = E2E_SOURCES | {"program_span", "program_counter"}


class ManifestError(ValueError):
    pass


def _need(cond, what):
    if not cond:
        raise ManifestError(what)


def _line(text, what):
    _need(isinstance(text, str) and 1 <= len(text) <= 200
          and "\n" not in text and "\t" not in text,
          f"{what}: 1 to 200 characters on one line, no tab")


def check(bench: dict) -> None:
    """Raise `ManifestError` unless ``bench`` keeps to the contract's rules
    on keys, names, units, metrics and cells."""
    _need(set(bench) == KEYS, f"BENCHMARK.json keys {sorted(bench)} are not "
          f"{sorted(KEYS)}")
    cmd = bench["command"]
    _need(isinstance(cmd, list) and 1 <= len(cmd) <= 32, "command: 1 to 32 "
          "strings")
    for word in cmd:
        _line(word, "a word of command")
    paths = bench["paths"]
    _need(isinstance(paths, list) and 1 <= len(paths) <= 16, "paths: 1 to 16")
    for p in paths:
        _need(isinstance(p, str) and PATH.match(p) and not p.startswith("/")
              and ".." not in p.split("/"), f"path {p!r}")
    rs = bench["run_seconds"]
    _need(isinstance(rs, int) and 1 <= rs <= 51, "run_seconds: 1 to 51")

    names = set()

    def name(n, what):
        _need(isinstance(n, str) and NAME.match(n), f"{what} name {n!r}")
        _need(n not in names, f"name {n!r} used twice")
        names.add(n)

    configs = {}
    for c in bench["configs"]:
        _need(set(c) == CONFIG_KEYS, f"config keys {sorted(c)}")
        name(c["name"], "config")
        _line(c["source"], "config source")
        _line(c["why"], "config why")
        _need(any(c["file"].startswith(p.rstrip("/") + "/") for p in paths),
              f"config file {c['file']} is not under paths")
        _need(isinstance(c["reduced"], list) and len(c["reduced"]) <= 16
              and all(isinstance(k, str) and NAME.match(k)
                      for k in c["reduced"]), f"config {c['name']} reduced")
        configs[c["name"]] = c
    _need(1 <= len(configs) <= 24, "configs: 1 to 24")
    _need(len({c["file"] for c in configs.values()}) == len(configs),
          "two configurations share a file")

    cells = {}
    pairs = set()
    for w in bench["workloads"]:
        _need(set(w) == CELL_KEYS, f"workload keys {sorted(w)}")
        name(w["name"], "workload")
        _need(w["config"] in configs, f"cell {w['name']}: no config "
              f"{w['config']}")
        _need(isinstance(w["traffic"], str) and NAME.match(w["traffic"]),
              f"cell {w['name']}: traffic {w['traffic']!r}")
        _need(w["chips"] in (1, 4), f"cell {w['name']}: chips 1 or 4")
        _line(w["why"], f"cell {w['name']} why")
        pair = (w["config"], w["traffic"])
        _need(pair not in pairs, f"config and traffic {pair} twice")
        pairs.add(pair)
        cells[w["name"]] = w
    _need(1 <= len(cells) <= 24, "workloads: 1 to 24")
    _need(all(any(w["config"] == c for w in cells.values())
              for c in configs), "a configuration no cell uses")

    e2e = {}
    for m in bench["end_to_end"]:
        _need(set(m) - {"workloads"} == E2E_KEYS,
              f"end_to_end keys {sorted(m)}")
        _metric(m, name)
        _need(m["source"] in E2E_SOURCES, f"{m['name']}: source "
              f"{m['source']!r}")
        b = m["bound"]
        _need(isinstance(b, (int, float)) and 0.01 <= b <= 0.25,
              f"{m['name']}: bound {b!r} outside 0.01..0.25")
        e2e[m["name"]] = _cells_of(m, cells)
    _need(1 <= len(e2e) <= 16, "end_to_end: 1 to 16")
    _need("setup_s" in e2e, "no setup_s")

    layers = {}
    for m in bench["per_layer"]:
        _need(set(m) - {"workloads"} == LAYER_KEYS,
              f"per_layer keys {sorted(m)}")
        _metric(m, name)
        _line(m["layer"], f"{m['name']} layer")
        _need(m["moves"] in e2e, f"{m['name']} moves {m['moves']!r}, which "
              f"is no end-to-end metric")
        listed = _cells_of(m, cells)
        _need(listed <= e2e[m["moves"]], f"{m['name']}: cells "
              f"{sorted(listed - e2e[m['moves']])} do not report "
              f"{m['moves']}")
        layers[m["name"]] = listed
    _need(1 <= len(layers) <= 128, "per_layer: 1 to 128")

    for w in cells:
        ends = [n for n, cs in e2e.items() if w in cs]
        _need("setup_s" in ends and len(ends) >= 2,
              f"cell {w}: reports {ends}; needs setup_s and one more")
        _need(any(w in cs for cs in layers.values()),
              f"cell {w}: no per-layer metric")
    _need(len(json.dumps(bench).encode()) <= 64 * 1024, "over 64 KiB")


def _metric(m, name):
    name(m["name"], "metric")
    _need(isinstance(m["unit"], str) and UNIT.match(m["unit"]),
          f"{m['name']}: unit {m['unit']!r}")
    _need(m["better"] in ("lower", "higher"), f"{m['name']}: better")
    _need(m["source"] in SOURCES, f"{m['name']}: source {m['source']!r}")


def _cells_of(m, cells) -> set:
    listed = m.get("workloads")
    if listed is None:
        return set(cells)
    _need(isinstance(listed, list) and listed and set(listed) <= set(cells),
          f"{m['name']}: workloads {listed}")
    return set(listed)


def load(path=None) -> dict:
    path = pathlib.Path(path or REPO / "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    check(bench)
    return bench


def cell(bench: dict, workload: str) -> dict:
    """The cell named ``workload``, with its configuration entry and the
    metrics it reports, end to end and per layer."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise ManifestError(f"no workload {workload!r}; have {sorted(cells)}")
    w = cells[workload]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])

    def reports(m):
        return workload in m.get("workloads", cells)

    return {"cell": w, "config": cfg,
            "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
            "per_layer": [m for m in bench["per_layer"] if reports(m)]}


def read_json(rel: str) -> dict:
    with open(REPO / rel) as f:
        return json.load(f)


def traffic(mix: str) -> dict:
    return read_json(f"flashr_bench/traffic/{mix}.json")


def module(kind: str, name: str):
    """``flashr_bench/<kind>/<name>.py`` loaded by its path (metric names
    hold dots, so they are no importable module names)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise ManifestError(f"no {kind} file {path.relative_to(REPO)}")
    spec = importlib.util.spec_from_file_location(
        f"flashr_bench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
