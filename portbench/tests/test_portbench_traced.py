"""A traced run of each cell on the CPU at the reduced size: the
per-layer metrics that read the program's spans and counters come out
finite and positive, and those of the device trace, which a CPU run has
none of, read None and are left out."""
import math
import time

import pytest

torch = pytest.importorskip("torch")

import portbench_testkit as K  # noqa: E402


@pytest.mark.parametrize("name", K.CELLS)
def test_a_traced_cpu_run_reads_every_program_metric(name):
    from pb.runner import run_cell
    torch.set_num_threads(1)
    cell, engines = K.reduced_cell(name), []
    out, _, _ = run_cell(cell, 2 ** 31 + 91, 3.0, True, "cpu",
                         time.perf_counter(), fault=engines.extend,
                         judge=False)
    assert out.record.trace is None
    for m in cell.per_layer:
        got = out.metrics.get(m.name)
        if m.source == "device_trace":
            assert got is None, m.name
        elif m.source == "program_span" or m.name == "kv_page_use":
            assert got is not None, m.name
            assert math.isfinite(got["value"]) and got["value"] > 0, m.name
    if "kv_page_use" in out.metrics:
        assert out.metrics["kv_page_use"]["value"] <= 100
    recs = [r for e in engines for r in e.trace.records()]
    assert recs and not any(r.profiled for r in recs)    # no profiler here
