"""Engine: evaluation (metrics, the one-card evaluator), inference front
ends (tagging, long audio, embedding extraction), and training (losses,
optimizer and schedules, the one-device trainer)."""
