"""Frontend, PCM decode and the fused block kernel."""
