"""Sum of the window's ``prefill`` event seconds over the sum of their
prompt tokens, in ms per 1000 tokens (``drain_events()``)."""


def read(run):
    ev = run.events("prefill")
    toks = sum(e[2] for e in ev)
    return sum(e[3] for e in ev) / toks * 1e6 if toks else None
