"""Run one cell of the benchmark of ``repro_torch`` once, on this machine.

    python3 portbench/run.py --workload <cell> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

From the root of a checkout holding ``BENCHMARK.json``, ``portbench/``
and ``src/``.  Set-up draws the weights from the seed on the card, builds
the port's engines (capturing their decode graphs), and serves the head
of the cell's traffic as warm-up; then the window is measured for
``--seconds``; then the served tokens of a sample of finished requests
are checked against the plain reference.  The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (``--trace 0``: the cell's end-to-end metrics; ``--trace
1``: its per-layer metrics, read over a profiled span at the window's
end), ``device``, ``breakdown`` (traced runs) and ``compared``, each
number compared beside its limit, which also ends standard error.

It exits non-zero, printing no result, without as many CUDA cards as the
cell asks for, and if JAX or the JAX package was loaded by the time the
window closed."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse     # noqa: E402
import json         # noqa: E402
import os           # noqa: E402
import subprocess   # noqa: E402
import sys          # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "portbench")]


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from pb import spec
    cell = spec.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell needs {cell.chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    from pb.runner import _loaded_jax, run_cell
    out, _, _ = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda", T_START)
    loaded = _loaded_jax()
    if loaded:
        print(f"portbench: loaded by the window's close: {loaded}",
              file=sys.stderr)
        return 3
    card = _power_limit()
    line = {"correct": bool(out.correct), "attempted": out.attempted,
            "failed": out.failed, "metrics": out.metrics,
            "device": {"platform": "gpu",
                       "kind": torch.cuda.get_device_name(0),
                       "count": cell.chips,
                       "memory_peak_bytes": int(out.memory_peak)}}
    tr = out.record.trace
    if tr is not None:
        line["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        line["breakdown"] = {"device_ops": tr.device_ops,
                             "idle_gaps": tr.idle_gaps}
    line["notes"] = dict(out.notes, card=card, setup_s=out.record.setup_s,
                         window_s=out.record.window_s, seed=args.seed)
    line["compared"] = out.compared
    print(json.dumps(line), flush=True)
    for name, c in out.compared.items():
        print(f"compared {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
