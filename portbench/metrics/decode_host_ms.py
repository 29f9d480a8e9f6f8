"""Mean over the window's ``decode`` spans (the profiler off) of the span
less its ``decode.wait`` child: the host's ms a step in filling the
inputs, launching the replay and reading the tokens back."""
from pb.spans import host_ms


def read(run):
    return host_ms(run)
