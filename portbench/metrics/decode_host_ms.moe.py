"""The MoE cell's decode: mean over the window's ``decode`` spans (the
profiler off) of the span less its ``decode.wait`` child, in ms."""
from pb.spans import host_ms


def read(run):
    return host_ms(run)
