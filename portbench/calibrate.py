"""Readings that the limit of a cell's check is set from, many seeds in
one process (the set-up of a seed is the run's own).

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2] [--seconds 30] [--out FILE]

For each seed it serves the cell for ``--seconds`` at the cell's own
load, exactly as ``run.py`` does, and prints one JSON line: the widest
gap of the served tokens below the float32 reference (the number the
check compares) and, on the control seeds, the widest gap of the tokens
that the reference computed in float8 puts first at the same positions
(the control, which has to fail the check)."""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "portbench")]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    from pb import spec
    from pb.runner import run_cell
    cell = spec.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        sys.exit("calibrate: needs a CUDA card")
    seconds = args.seconds or cell.run_seconds
    control = {int(s) for s in args.control_seeds.split(",") if s}
    sink = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        torch.cuda.reset_peak_memory_stats()
        out, w, chosen = run_cell(cell, seed, seconds, False, "cuda",
                                  time.perf_counter(),
                                  check_mode="fp8" if seed in control
                                  else "fp32")
        c = out.compared
        line = {"cell": args.workload, "seed": seed, "seconds": seconds,
                "tokens": c["tokens_checked"]["value"],
                "metrics": {k: v["value"] for k, v in out.metrics.items()},
                "notes": out.notes}
        ours, other = out.notes["gap_stats"], out.notes["other_gap_stats"]
        if seed in control:
            ours, other = other, ours
        line.update(gap=ours["max"], gap_mean=ours["mean"])
        if other:
            line.update(control_gap=other["max"],
                        control_gap_mean=other["mean"])
        print(json.dumps(line), flush=True)
        if sink:
            sink.write(json.dumps(line) + "\n")
            sink.flush()
        del out, w, chosen
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
