"""Clips a batch of the tagging service over the window: the difference of
``InferenceService.counters()`` clips over batches, read before and after."""


def read(run):
    c = run.counters
    if not c.get("service.batches"):
        return None
    return c["service.clips"] / c["service.batches"]
