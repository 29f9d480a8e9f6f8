"""Time average over the window of the KV pages in use over the pool's
pages, summed over the engines, each engine's count as its ``decode``
spans sampled it (holding until its next one), in %."""
from pb.readings import time_average
from pb.spans import tracers


def read(run):
    used = pool = 0.0
    for tr in tracers(run):
        dec = sorted((r for r in tr.records() if r.name == "decode"
                      and r.attrs and "pool" in r.attrs), key=lambda r: r.t0)
        if not dec:
            continue
        samples = [(r.t0, r.attrs["pages"]) for r in dec
                   if r.t0 < run.t_end] + [(run.t_end, 0)]
        used += time_average(samples, run.t_w, run.t_end) or 0.0
        pool += dec[-1].attrs["pool"]
    return 100.0 * used / pool if pool else None
