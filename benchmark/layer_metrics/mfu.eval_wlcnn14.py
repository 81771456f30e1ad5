"""Wavegram-Logmel-CNN14's eval model step's share of the card's bf16
peak: the model's FLOPs per clip (benchmark/counts_pann.py: the frontend's
FFT and mel product, twice the multiply-adds of every convolution and
linear layer) times the clips answered per second of the window, over
989 TFLOP/s a card."""

from benchmark import counts, counts_pann


def read(run):
    rate = run.end_to_end.get("eval_clips_per_s")
    if not rate:
        return None
    flops = counts_pann.model_flops(run.config["model"], run.traffic["samples"])
    return 100.0 * flops * rate / (counts.PEAK_BF16_FLOPS * run.chips)
