"""Process start to the window's start: drawing the weights, building the
engines and capturing their decode graphs, the kernels' build where it is
the first run in the checkout, and the warm-up traffic."""


def read(run):
    return run.setup_s
