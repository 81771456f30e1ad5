"""Share of the traced part of the training window in which the card was
idle while the port's ``train.optimizer`` span was open on the thread that
runs the steps (rank 0's trace on several cards)."""

from benchmark import program_spans as ps


def read(run):
    tr = run.trace
    if tr is None or tr.window_s() <= 0 or not ps.program_spans(tr, ["train.step"]):
        return None
    return 100.0 * ps.idle_under(tr, ["train.optimizer"]) / tr.window_s()
