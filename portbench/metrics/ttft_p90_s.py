"""90th percentile over the requests due in the window of first token
less due time; one without a token by the window's end counts its age
then."""
from pb.readings import p90


def read(run):
    waits = [(tr.first_t if tr.first_t is not None and tr.first_t < run.t_end
              else run.t_end) - tr.due for tr in run.due_in_window()]
    return p90(waits)
