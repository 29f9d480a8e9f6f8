"""90th percentile over requests of (last token - first token) / (tokens
- 1), counting only tokens produced inside the window, over requests with
at least two of them."""
from pb.readings import p90, tokens_in_window


def read(run):
    per = []
    for tr in run.loop.tracked:
        n, first, last = tokens_in_window(run, tr)
        if n >= 2:
            per.append((last - first) / (n - 1) * 1e3)
    return p90(per)
