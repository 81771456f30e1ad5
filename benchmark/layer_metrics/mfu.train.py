"""The training step's share of the cards' bf16 peak: three trunk forwards
(forward and backward) per clip after mixup plus the frontend's forward
per clip brought in (benchmark/counts.py), at the window's rate, over
989 TFLOP/s times the cards used."""

from benchmark import counts


def read(run):
    rate = run.end_to_end.get("train_clips_per_s")
    c = run.counters
    if not rate or not c.get("train.trunk_clips"):
        return None
    per = counts.train_flops(run.config["model"], run.traffic["samples"], 1.0,
                             c["train.input_clips"] / c["train.trunk_clips"])
    return 100.0 * per * rate / (counts.PEAK_BF16_FLOPS * run.chips)
