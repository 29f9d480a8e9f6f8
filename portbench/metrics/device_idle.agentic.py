"""1 - (the union of the device operations' intervals) / (the traced
span), in %."""
from pb.readings import idle_share


def read(run):
    return idle_share(run)
