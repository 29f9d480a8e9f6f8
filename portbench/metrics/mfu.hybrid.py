"""Model flops of every step of the window, counting the experts each
token uses (top-k routed and the shared one), the attention pairs and each
Mamba-2 layer's scan (``Counts.ssd_call`` in prefill, ``Counts.mamba_step``
in decode), over the sum of all event seconds at 989 TFLOP/s, in %."""
from pb.readings import decode_flops, event_sum, mfu, prefill_flops


def read(run):
    return mfu(decode_flops(run) + prefill_flops(run),
               event_sum(run, None)[0])
