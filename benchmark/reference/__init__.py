"""The benchmark's plain reference: float32 PyTorch, independent of the
program under test (it imports nothing of it)."""
