"""Kernel B2 (``kernels/flash_attention``) over the traced span: the sum
of each call's bound (the larger of its flops at 989 TFLOP/s and its
bytes, q, k, v and the output once, at 3.35 TB/s) over the device time
of B2's kernels.  Calls: each one-shot prompt and each chunk over its
prefix, once a layer."""
from pb.readings import FLASH, roofline


def read(run):
    c = run.counts
    return roofline(run, FLASH, lambda s: [c.flash_call(lq, lk)
                                           for lq, lk in s.flash
                                           for _ in range(c.flash_layers())])
