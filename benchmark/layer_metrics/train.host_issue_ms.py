"""Host time to issue one training step: the benchmark's span around each
``Trainer.step_async`` call of the window (the enqueue, not the card's
work), mean over the window's steps (host clock)."""


def read(run):
    c = run.counters
    if not c.get("train.steps"):
        return None
    return 1e3 * c["train.issue_s"] / c["train.steps"]
