"""Requests due in the window that produced all their tokens by their
deadline (due time + slo), per second of window.  A request still running
when its deadline passed missed it; the run serves on past the window
(``drain_s``) so that each is decided."""


def read(run):
    due = run.due_in_window()
    good = sum(1 for tr in due
               if tr.done_t is not None and tr.done_t <= tr.deadline)
    return good / run.window_s
