"""Device time of stages 3-4 a batch (downsamples 2-3 and the K1
blocks): the union of the intervals of the kernels, copies and sets
launched inside the port's ``model.stage3`` and ``model.stage4`` spans
(the launch call, linked by correlation id, on the thread that holds the
span), per ``eval.launch`` span of the traced part whose work all ran
inside it."""

from benchmark import program_spans as ps

SPANS = ["model.stage3", "model.stage4"]


def read(run):
    tr = run.trace
    if tr is None:
        return None
    return ps.device_ms_per_root(tr, SPANS, "eval.launch")
