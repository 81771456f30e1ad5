"""Device time of the step's collectives (the flat-buffer gradient
all-reduce and bn0's statistics), per step and card: the port's
``Trainer.collectives.ms()`` (CUDA events around each collective) over the
window's steps, averaged over the ranks."""


def read(run):
    return run.counters.get("train.allreduce_ms")
