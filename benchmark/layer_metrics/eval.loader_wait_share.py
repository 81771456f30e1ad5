"""Share of the eval window the Evaluator spent waiting on the loader: the
benchmark's host span around each ``next()`` of the DataLoader it hands to
``Evaluator.infer_probs``, summed, over the window (host clock)."""


def read(run):
    c = run.counters
    if not c.get("eval.window_s"):
        return None
    return 100.0 * c["eval.loader_wait_s"] / c["eval.window_s"]
