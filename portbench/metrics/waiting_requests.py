"""Time average over the window of requests routed to an engine but
holding no slot (``load`` less occupied ``slots``), sampled each pass."""
from pb.readings import time_average


def read(run):
    return time_average(run.loop.waits, run.t_w, run.t_end)
