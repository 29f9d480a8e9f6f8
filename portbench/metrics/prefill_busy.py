"""Of the ``prefill.call`` spans opened under the profiler, the share of
their time, placed on the trace's clock, that device operations cover, in
%: how far eager prefill keeps the card busy."""
from pb.spans import busy_share


def read(run):
    return busy_share(run, "prefill.call")
