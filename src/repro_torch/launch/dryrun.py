"""The multi-pod dry run.

Counterpart of ``repro/launch/dryrun.py``.  For every (architecture x
input-shape) cell, run the step once on the production mesh (single-pod
16x16 and multi-pod 2x16x16) in a fake world of 256 or 512 ranks, on meta
tensors placed as the sharding rules place them, counting one rank's work
with ``op_cost.OpCounter``: flops, a bytes proxy, collectives, peak live
bytes; and persist it to ``results/dryrun_torch/<cell>.json``.  The run is
host work: it allocates nothing on any device.  ``trace_s`` stands for the
reference's ``lower_s`` and ``compile_s``; ``memory`` holds the arguments'
bytes on one rank, the outputs', the peak of the step's own allocations
(``temp_bytes``) and their sum (``peak_bytes``).  Unlike the reference's,
this module sets no environment variable.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-27b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes [--skip-done]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --table
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

from repro_torch.configs import SHAPES, assigned_cells, shape_applicable

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


def local_bytes(tree) -> int:
    """Bytes that one rank holds of the tensors in ``tree`` (a tensor, a
    ``Model``, or dicts, lists and tuples of them)."""
    import torch
    from torch.distributed.tensor import DTensor
    if isinstance(tree, torch.nn.Module):
        return sum(local_bytes(p) for p in tree.parameters())
    if isinstance(tree, DTensor):
        tree = tree.to_local()
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(v) for v in tree)
    return 0


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             save: bool = True) -> dict:
    from repro_torch.launch.mesh import fake_world, make_production_mesh
    from repro_torch.launch.op_cost import OpCounter
    from repro_torch.launch.specs import build_cell
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod)
    fn, kwargs, _, _, meta = build_cell(arch, shape_name, mesh)
    arg_bytes = local_bytes(kwargs)
    t0 = time.time()
    with OpCounter() as counter:
        out = fn(**kwargs)
    trace_s = time.time() - t0
    cost = counter.analyze()
    n_dev = mesh.size()

    rec = dict(meta)
    rec.update({
        "multi_pod": multi_pod,
        "n_devices": n_dev,
        "trace_s": round(trace_s, 2),
        "flops_per_device": cost["flops_per_device"],
        "bytes_accessed_per_device": cost["bytes_accessed_per_device"],
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": local_bytes(out),
            "temp_bytes": counter.peak,
            "peak_bytes": arg_bytes + counter.peak,
        },
        "collectives": cost["collectives"],
        "collective_wire_bytes_per_device":
            cost["collective_wire_bytes_per_device"],
        "kernels": cost["kernels"],
    })
    if save:
        RESULTS.mkdir(parents=True, exist_ok=True)
        tag = "multipod" if multi_pod else "pod"
        path = RESULTS / f"{arch}__{shape_name}__{tag}.json"
        path.write_text(json.dumps(rec, indent=1, default=float))
        rec["saved_to"] = str(path)
    return rec


def _summary_line(rec: dict) -> str:
    mem = rec["memory"]
    # arguments dominate persistent state (params/opt/cache); temp = activations
    per_dev_gb = (mem["argument_bytes"] + mem["temp_bytes"]) / 1e9
    return (f"{rec['arch']:22s} {rec['shape']:12s} "
            f"{'2pod' if rec['multi_pod'] else '1pod':5s} "
            f"trace={rec['trace_s']:7.1f}s "
            f"flops/dev={rec['flops_per_device']:.3e} "
            f"mem/dev={per_dev_gb:6.2f}GB "
            f"coll/dev={rec['collective_wire_bytes_per_device'] / 1e6:9.1f}MB")


def table(results: Path = RESULTS) -> str:
    """The saved records as a markdown table, one row a cell, the single-
    and multi-pod meshes side by side (``1pod / 2pod``): per-device flops,
    bytes proxy, argument and peak GB, and collective wire MB by kind."""
    import torch
    recs = {}
    for f in sorted(results.glob("*.json")):
        r = json.loads(f.read_text())
        recs.setdefault((r["arch"], r["shape"]), {})[r["multi_pod"]] = r

    def both(fn, fmt):
        return " / ".join(fmt.format(fn(by[mp])) if mp in by else "-"
                          for mp in (False, True))

    def coll(kind):
        return lambda r: r["collectives"].get(kind, {}).get("wire_bytes",
                                                            0) / 1e6
    rows = [f"Host-counted by `launch/dryrun.py` (torch {torch.__version__}): "
            "one rank, no time, no card.", "",
            "| cell | flops/dev | bytes/dev | arg GB | peak GB | "
            "all-gather MB | all-reduce MB | reduce-scatter MB |",
            "|---|---|---|---|---|---|---|---|"]
    for arch, shape in assigned_cells():
        by = recs.get((arch, shape), {})
        rows.append(
            f"| {arch} {shape} | "
            f"{both(lambda r: r['flops_per_device'], '{:.3e}')} | "
            f"{both(lambda r: r['bytes_accessed_per_device'], '{:.3e}')} | "
            f"{both(lambda r: r['memory']['argument_bytes'] / 1e9, '{:.2f}')}"
            f" | {both(lambda r: r['memory']['peak_bytes'] / 1e9, '{:.2f}')}"
            f" | {both(coll('all-gather'), '{:.0f}')} | "
            f"{both(coll('all-reduce'), '{:.0f}')} | "
            f"{both(coll('reduce-scatter'), '{:.0f}')} |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--table", action="store_true",
                    help="print the saved records as a markdown table")
    args = ap.parse_args(argv)
    if args.table:
        print(table())
        return

    cells = (list(assigned_cells()) if args.all
             else [(args.arch, args.shape)])
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = []
    # one mesh at a time: each is its own fake world
    for mp in meshes:
        tag = "multipod" if mp else "pod"
        for arch, shape_name in cells:
            if not shape_applicable(arch, shape_name):
                print(f"{arch:22s} {shape_name:12s} SKIP (long_500k: no "
                      f"bounded-KV path)")
                continue
            done = RESULTS / f"{arch}__{shape_name}__{tag}.json"
            if args.skip_done and done.exists():
                print(f"{arch:22s} {shape_name:12s} {tag:8s} done (cached)")
                continue
            try:
                rec = run_cell(arch, shape_name, mp)
                print(_summary_line(rec), flush=True)
            except Exception as e:  # noqa: BLE001 - report and continue
                failures.append((arch, shape_name, mp, repr(e)))
                print(f"{arch:22s} {shape_name:12s} {tag:8s} FAIL: {e}")
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nall dry-run cells green")


if __name__ == "__main__":
    main()
