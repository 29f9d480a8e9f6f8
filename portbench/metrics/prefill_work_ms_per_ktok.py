"""Sum of the window's ``prefill.call`` span seconds (each one-shot
prefill or chunk call, without the decode steps between chunks; the
profiler off) over the sum of their tokens, in ms per 1000 tokens."""
from pb.spans import closed


def read(run):
    calls = [r for _, r in closed(run, "prefill.call")]
    toks = sum(r.attrs["tokens"] for r in calls)
    return sum(r.dt for r in calls) / toks * 1e6 if toks else None
