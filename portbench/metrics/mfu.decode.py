"""Model flops of the window's decode steps (2 x the layers' weights x
active rows, the head, attention over each context) over the sum of the
``decode`` event seconds at 989 TFLOP/s, in %."""
from pb.readings import decode_flops, event_sum, mfu


def read(run):
    return mfu(decode_flops(run), event_sum(run, "decode")[0])
