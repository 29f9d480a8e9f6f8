"""Model flops of the window's prefills (their causal pairs, the head on
the last token) over the sum of the ``prefill`` event seconds at 989
TFLOP/s, in %.  A chunked prefill's event spans the steps between its
chunks."""
from pb.readings import event_sum, mfu, prefill_flops


def read(run):
    return mfu(prefill_flops(run), event_sum(run, "prefill")[0])
