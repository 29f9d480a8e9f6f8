"""Mean of the window's ``decode`` event seconds (one replayed decode
step of one engine), in ms."""
from pb.readings import event_sum


def read(run):
    total, ev = event_sum(run, "decode")
    return total / len(ev) * 1e3 if ev else None
