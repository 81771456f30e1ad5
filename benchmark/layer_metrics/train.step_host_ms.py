"""Host time of one training step inside the program: the port's
``train.step`` span around the body of ``Trainer.step_async`` (the enqueue,
not the card's work), mean over the steps of the traced part (device
trace's host clock). The in-program twin of ``train.host_issue_ms``."""

from benchmark import program_spans as ps


def read(run):
    tr = run.trace
    if tr is None:
        return None
    return ps.per_root(tr, ps.span_host_s(tr, ["train.step"]), "train.step")
