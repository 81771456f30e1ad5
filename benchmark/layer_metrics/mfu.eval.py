"""The eval model step's share of the card's bf16 peak: the model's FLOPs
per clip (benchmark/counts.py: frontend FFT and mel product, twice the
trunk's multiply-adds) times the clips answered per second of the window,
over 989 TFLOP/s."""

from benchmark import counts


def read(run):
    rate = run.end_to_end.get("eval_clips_per_s")
    if not rate:
        return None
    flops = counts.model_flops(run.config["model"], run.traffic["samples"])
    return 100.0 * flops * rate / (counts.PEAK_BF16_FLOPS * run.chips)
