"""Find an open-loop cell's knee: serve it at each of several rates (one
process, one set-up a rate) and print, per rate, the mean of
``waiting_requests`` over each third of the window with the end-to-end
metrics.  The knee is the highest rate at which the waiting requests do
not grow through the window; the cell offers about 0.8 of it.

    python3 portbench/sweep.py --workload <cell> --rates 2,2.5,3 \\
        [--seconds 45] [--seed 1]"""
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
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    import torch
    from pb import spec
    from pb.readings import time_average
    from pb.runner import run_cell
    cell = spec.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        sys.exit("sweep: needs a CUDA card")
    seconds = args.seconds or cell.run_seconds
    for rate in (float(r) for r in args.rates.split(",")):
        cell.settings = dict(cell.settings, rate_rps=rate)
        out, w, _ = run_cell(cell, args.seed, seconds, False, "cuda",
                             time.perf_counter(), judge=False)
        rec = out.record
        thirds = [time_average(rec.loop.waits,
                               rec.t_w + k * rec.window_s / 3,
                               rec.t_w + (k + 1) * rec.window_s / 3)
                  for k in range(3)]
        print(json.dumps({"rate_rps": rate, "waiting_by_third": thirds,
                          "attempted": out.attempted,
                          "metrics": {k: v["value"]
                                      for k, v in out.metrics.items()},
                          "notes": out.notes}), flush=True)
        del out, w, rec
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
