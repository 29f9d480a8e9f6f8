"""The serving loop rehearsed on the CPU at a reduced size: every cell
serves, reports its end-to-end metrics and passes its check; the command
itself, without a card, fails and prints no result, as it does in a
directory holding only the benchmark's files."""
import json
import os
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import portbench_testkit as K  # noqa: E402


@pytest.mark.parametrize("name", K.CELLS)
def test_cpu_rehearsal_serves_and_passes_its_check(name):
    out, _, chosen = K.run_reduced(name)
    assert out.correct, out.compared
    assert out.attempted > 0 and out.failed == 0
    assert set(out.metrics) == {m.name for m in
                                K.reduced_cell(name).end_to_end}
    # every deadline may pass on a loaded CPU, so goodput may read 0 here
    assert all(v["value"] >= 0 for v in out.metrics.values())
    assert all(v["value"] > 0 for k, v in out.metrics.items()
               if k != "goodput_rps")
    if "minicpm" in name:        # one-shot and chunked prefill both judged
        assert {tr.engine for tr in chosen} == {0, 1}


def _command(cwd):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "minicpm-2b.agentic", "--seed", "3", "--seconds", "1", "--trace",
         "0"], cwd=cwd, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_without_a_card_the_command_fails_and_prints_no_result():
    r = _command(K.ROOT)
    assert r.returncode != 0
    assert not any(line.startswith("{") for line in r.stdout.splitlines())


def test_benchmark_files_alone_do_not_run(tmp_path):
    shutil.copy(K.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(K.BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _command(tmp_path)
    assert r.returncode != 0 and "{" not in r.stdout
