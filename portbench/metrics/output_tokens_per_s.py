"""Every token generated inside the window, per second of window."""
from pb.readings import tokens_in_window


def read(run):
    return sum(tokens_in_window(run, tr)[0]
               for tr in run.loop.tracked) / run.window_s
