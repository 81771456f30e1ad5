"""Device time of a PANN's 2-D trunk a batch (``conv_block1``, the concat
with the Wavegram, ``conv_block2`` to ``conv_block6``): the union of the
intervals of the kernels, copies and sets launched inside the port's
``model.trunk`` span (the launch call, linked by correlation id, on the
thread that holds the span), per ``eval.launch`` span of the traced part
whose work all ran inside it. A program without the span gives None."""

from benchmark import program_spans as ps

SPANS = ["model.trunk"]


def read(run):
    tr = run.trace
    if tr is None:
        return None
    return ps.device_ms_per_root(tr, SPANS, "eval.launch")
