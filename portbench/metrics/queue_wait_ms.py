"""90th percentile of the ``queued`` spans that closed in the window,
opened with the profiler off: a request's time from its engine's
``submit`` to the start of its admission, in ms."""
from pb.readings import p90
from pb.spans import closed


def read(run):
    return p90([r.dt * 1e3 for _, r in closed(run, "queued")])
