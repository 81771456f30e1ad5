"""Host time the Evaluator waits for a batch: the port's
``eval.wait_batch`` span around each ``next()`` of the loader inside
``Evaluator.infer_probs``, mean over the spans that lie wholly in the
traced part. The in-program twin of ``eval.loader_wait_share``."""

from benchmark import program_spans as ps


def read(run):
    tr = run.trace
    if tr is None:
        return None
    return ps.per_root(tr, ps.span_host_s(tr, ["eval.wait_batch"]), "eval.wait_batch")
