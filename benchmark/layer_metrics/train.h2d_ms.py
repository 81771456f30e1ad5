"""Host time a training step spends issuing the clips' and targets' copies
to the card: the port's ``train.h2d`` span (the two ``.to(device,
non_blocking=True)`` calls; from pageable memory the host waits for the
copy), per ``train.step`` span of the traced part."""

from benchmark import program_spans as ps


def read(run):
    tr = run.trace
    if tr is None:
        return None
    return ps.per_root(tr, ps.span_host_s(tr, ["train.h2d"]), "train.step")
