"""The hybrid cell's decode step: mean of the window's ``decode`` event
seconds (one replayed decode step of one engine: 36 Mamba-2 state updates,
4 attention layers over pages and 40 MoE layers over every slot), in ms."""
from pb.readings import event_sum


def read(run):
    total, ev = event_sum(run, "decode")
    return total / len(ev) * 1e3 if ev else None
