"""Kernel B3 (``kernels/ssd``, its three passes) over the traced span: the
sum of each call's bound (``Counts.ssd_call``: the causal pairs in each
chunk and the chunk states at 989 TFLOP/s, or x, B, C, dt read and y and
the float32 state written at 3.35 TB/s) over the device time of B3's
kernels.  Calls: each one-shot prompt, once a Mamba-2 layer."""
import re

from pb.readings import roofline

SSD = re.compile(r"\(anonymous namespace\)::ssd_\w*kernel")


def read(run):
    c = run.counts
    if not c.mamba_layers():
        return None
    return roofline(run, SSD, lambda s: [c.ssd_call(lq) for lq, lk in s.flash
                                         if lq == lk
                                         for _ in range(c.mamba_layers())])
