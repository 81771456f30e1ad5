"""Device time of stages 1-2 a batch (the stem, downsample 1 and their
blocks, in ATen): the union of the intervals of the kernels, copies and
sets launched inside the port's ``model.stage1`` and ``model.stage2``
spans (the launch call, linked by correlation id, on the thread that holds
the span), per ``eval.launch`` span of the traced part whose work all
ran inside it."""

from benchmark import program_spans as ps

SPANS = ["model.stage1", "model.stage2"]


def read(run):
    tr = run.trace
    if tr is None:
        return None
    return ps.device_ms_per_root(tr, SPANS, "eval.launch")
