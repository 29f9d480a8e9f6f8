"""The benchmark's files, found by name.

``BENCHMARK.json`` at the root of the checkout names the cells; a cell
names a configuration (``portbench/configs/<config>.json``, whose
``reference`` key names ``portbench/reference/<reference>.py``) and a
traffic mix (``portbench/traffic/<traffic>.json``); the cell's own
settings (its offered rate, the limit of its check) are in
``portbench/cells/<cell>.json``; each metric is read by
``portbench/metrics/<metric>.py``.  A configuration's ``port`` section
holds any field of the port's ``ModelConfig`` (``pb.program``) and its
``layers`` in ``stages``' format; its reference module names the leaves
to draw and the CPU tests' cut.  A later cell, mix, configuration or
metric is new files and a new entry, with no edit here."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from typing import List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    workloads: Optional[List[str]]
    layer: str = ""
    moves: str = ""

    def reported_in(self, cell: str, bench: dict) -> bool:
        if self.workloads is not None:
            return cell in self.workloads
        if self.moves:      # a per-layer metric: where its end-to-end one is
            e2e = {m["name"]: m for m in bench["end_to_end"]}[self.moves]
            return e2e.get("workloads") is None or cell in e2e["workloads"]
        return True


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    settings: dict
    chips: int
    end_to_end: List[Metric]
    per_layer: List[Metric]
    run_seconds: int
    bench_dir: Path = BENCH_DIR


def read_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_bench(root: Path) -> dict:
    return read_json(root / "BENCHMARK.json")


def _metrics(bench: dict, key: str) -> List[Metric]:
    return [Metric(m["name"], m["unit"], m["better"], m["source"],
                   m.get("workloads"), m.get("layer", ""), m.get("moves", ""))
            for m in bench[key]]


def load_cell(root: Path, name: str, bench_dir: Path = BENCH_DIR) -> Cell:
    bench = load_bench(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    conf = read_json(bench_dir / "configs" / f"{w['config']}.json")
    traffic = read_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    settings_path = bench_dir / "cells" / f"{name}.json"
    settings = read_json(settings_path) if settings_path.exists() else {}
    return Cell(name, conf, traffic, settings, int(w["chips"]),
                [m for m in _metrics(bench, "end_to_end")
                 if m.reported_in(name, bench)],
                [m for m in _metrics(bench, "per_layer")
                 if m.reported_in(name, bench)],
                int(bench["run_seconds"]), bench_dir)


def _load_file(kind: str, name: str, bench_dir: Path):
    path = bench_dir / kind / f"{name}.py"
    key = f"portbench_{kind}.{name}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """``portbench/metrics/<name>.py``: its ``read(run)`` gives the value,
    or None where the run holds nothing to read."""
    return _load_file("metrics", name, bench_dir)


def reference(conf: dict, bench_dir: Path = BENCH_DIR):
    """``portbench/reference/<reference>.py``, the plain reference that the
    configuration names: ``leaves(conf, vocab_rows)``, ``logits`` and
    ``reduced(conf)``, its cut to a size the CPU tests hold."""
    return _load_file("reference", conf["reference"], bench_dir)


LAYER_KEYS = {"mixer", "ffn", "window"}


def stages(port: dict) -> List[tuple]:
    """The ``layers`` of a ``port`` section as (pattern, repeat), a pattern
    being a list of {"mixer", "ffn"[, "window"]}.  An entry is one layer
    kind, ``{"mixer", "ffn"[, "window"], "repeat"}``, or a period of
    several, ``{"pattern": [...], "repeat"}``.  A key it does not know
    raises."""
    out = []
    for entry in port["layers"]:
        if "pattern" in entry:
            pattern, unknown = entry["pattern"], set(entry) - {"pattern",
                                                               "repeat"}
        else:
            pattern = [{k: v for k, v in entry.items() if k != "repeat"}]
            unknown = set()
        for blk in pattern:
            unknown |= set(blk) - LAYER_KEYS
        if unknown:
            raise ValueError(f"layers entry {entry}: unknown keys "
                             f"{sorted(unknown)}")
        out.append((pattern, int(entry["repeat"])))
    return out
