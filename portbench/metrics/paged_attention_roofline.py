"""Kernel B1 (``kernels/paged_attention``, pass 1 and merge) over the
traced span: the sum of each call's bound (every context row of K and V
read once a layer and active slot, plus q and the output) over the device
time of B1's kernels.  Calls: one a full attention layer and decode step."""
from pb.readings import PAGED, roofline


def read(run):
    c = run.counts
    return roofline(run, PAGED, lambda s: [c.paged_call(s.ctxs)
                                           for _ in range(c.flash_layers())]
                    if s.ctxs else [])
