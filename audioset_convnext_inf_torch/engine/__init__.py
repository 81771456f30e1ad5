"""Engine: evaluation (metrics, the evaluator on one device or several),
inference front ends (tagging, long audio, embedding extraction), the
tagging service, and training (losses, optimizer and schedules, the
trainer on one card or data-parallel)."""
