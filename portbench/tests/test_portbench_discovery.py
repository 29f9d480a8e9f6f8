"""A cell, a mix, a configuration and a metric are found by their names
from added files alone: a copy of the benchmark's files plus new ones,
with no edit to any file there."""
import json
import shutil

import pytest

pytest.importorskip("torch")

import portbench_testkit as K  # noqa: E402
from pb import spec  # noqa: E402


def test_new_cell_mix_and_metric_from_added_files(tmp_path):
    bench_dir = tmp_path / "portbench"
    for sub in ("configs", "traffic", "cells", "metrics"):
        shutil.copytree(K.BENCH / sub, bench_dir / sub)
    bench = json.loads((K.ROOT / "BENCHMARK.json").read_text())
    mix = json.loads((K.BENCH / "traffic" / "agentic.json").read_text())
    mix["mix"] = {"kind": "families", "families": ["sql"]}
    (bench_dir / "traffic" / "bursty_short.json").write_text(json.dumps(mix))
    (bench_dir / "cells" / "minicpm-2b.bursty_short.json").write_text(
        json.dumps({"rate_rps": 6.0, "check_tokens": 600,
                    "limits": {"logit_gap": 0.3}}))
    (bench_dir / "metrics" / "sent_requests.py").write_text(
        "def read(run):\n    return float(len(run.loop.tracked))\n")
    bench["workloads"].append({"name": "minicpm-2b.bursty_short",
                               "config": "minicpm-2b",
                               "traffic": "bursty_short", "chips": 1,
                               "why": "sql only"})
    next(m for m in bench["end_to_end"] if m["name"] == "tpot_p90_ms")[
        "workloads"].append("minicpm-2b.bursty_short")
    bench["per_layer"].append({"name": "sent_requests", "unit": "requests",
                               "better": "higher", "source": "host_clock",
                               "layer": "router and admission",
                               "moves": "tpot_p90_ms",
                               "workloads": ["minicpm-2b.bursty_short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell(tmp_path, "minicpm-2b.bursty_short", bench_dir)
    assert cell.traffic["mix"]["families"] == ["sql"]
    assert cell.settings["rate_rps"] == 6.0
    assert [m.name for m in cell.end_to_end] == ["tpot_p90_ms", "setup_s"]
    assert [m.name for m in cell.per_layer] == ["sent_requests"]
    reader = spec.metric_reader("sent_requests", bench_dir)
    run = type("R", (), {"loop": type("L", (), {"tracked": [1, 2, 3]})})
    assert reader.read(run) == 3.0


@pytest.mark.parametrize("name", K.CELLS)
def test_every_cell_finds_its_files(name):
    cell = spec.load_cell(K.ROOT, name)
    assert spec.reference(cell.config).logits
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.metric_reader(m.name).read)
    assert cell.settings["limits"] and all(
        v > 0 for v in cell.settings["limits"].values())
