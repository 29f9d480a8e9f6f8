"""Mean over the window's ``prefill.state`` spans (the profiler off) of
their ms: the host's time in writing one admitted request's conv history
and float32 SSM state into its slot of ``SSMStateCache`` (36 layers x 4
tensors at granite's widths), with no synchronise of its own."""
from pb.spans import closed


def read(run):
    spans = [r for _, r in closed(run, "prefill.state")]
    return sum(r.dt for r in spans) / len(spans) * 1e3 if spans else None
