"""Device time of a PANN's Wavegram branch a batch (``pre_conv0`` through
``pre_block4``): the union of the intervals of the kernels, copies and
sets launched inside the port's ``model.wavegram`` span (the launch call,
linked by correlation id, on the thread that holds the span), per
``eval.launch`` span of the traced part whose work all ran inside it. A
program without the span gives None."""

from benchmark import program_spans as ps

SPANS = ["model.wavegram"]


def read(run):
    tr = run.trace
    if tr is None:
        return None
    return ps.device_ms_per_root(tr, SPANS, "eval.launch")
