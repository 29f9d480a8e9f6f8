"""``BENCHMARK.json`` keeps to the benchmark's contract: its keys, names,
units, bounds, cells and the configuration files it names."""
import json
import re

import pytest

pytest.importorskip("torch")

import portbench_testkit as K  # noqa: E402

BENCH = json.loads((K.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH_WORDS = ("hidden", "intermediate", "lora", "head", "_dim", "_rank",
               "experts_per_tok", "expand", "state", "proj")


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((K.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= len(BENCH["command"]) <= 32 and all(map(_line,
                                                        BENCH["command"]))
    assert isinstance(BENCH["run_seconds"], int) and \
        1 <= BENCH["run_seconds"] <= 51


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("portbench/") and len(c["reduced"]) <= 16
        conf = json.loads((K.ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"] and conf["source"].startswith(
            c["source"])
        for key in c["reduced"]:
            assert NAME.match(key)
            assert not any(w in key for w in WIDTH_WORDS), key
            assert conf["published"][key] != conf.get(key)
            if isinstance(conf["published"][key], dict):  # no width moves
                for k, v in conf["published"][key].items():
                    if any(w in k for w in WIDTH_WORDS):
                        assert conf[key][k] == v, (key, k)


def test_cells():
    names = [w["name"] for w in BENCH["workloads"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(names) // 4)


def test_metrics():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        moved = e2e[m["moves"]].get("workloads") or cells
        assert set(m["workloads"]) <= set(moved)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["source"] in ("device_trace", "program_span")
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:      # setup_s, another end-to-end one, a per-layer one
        mine = [m for m in BENCH["end_to_end"]
                if cell in m.get("workloads", cells)]
        assert len(mine) >= 2
        assert any(cell in m.get("workloads", cells)
                   for m in BENCH["per_layer"])


def test_every_file_is_named_from_name_characters():
    for p in K.BENCH.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = str(p.relative_to(K.ROOT))
        assert re.match(r"^[A-Za-z0-9_.\-/]+$", rel), rel
