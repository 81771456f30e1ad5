"""Device time of the frontend a batch (STFT, log-mel, bn0; the int16
decode runs before it): the union of the intervals of the kernels, copies
and sets launched inside the port's ``model.frontend`` span (the launch
call, linked by correlation id, on the thread that holds the span), per
``eval.launch`` span of the traced part whose work all ran inside it."""

from benchmark import program_spans as ps

SPANS = ["model.frontend"]


def read(run):
    tr = run.trace
    if tr is None:
        return None
    return ps.device_ms_per_root(tr, SPANS, "eval.launch")
