"""Host time a training step spends in the optimizer: the port's
``train.optimizer`` span around ``Optimizer.step`` (AdamW's loop over the
parameters), per ``train.step`` span of the traced part."""

from benchmark import program_spans as ps


def read(run):
    tr = run.trace
    if tr is None:
        return None
    return ps.per_root(tr, ps.span_host_s(tr, ["train.optimizer"]), "train.step")
