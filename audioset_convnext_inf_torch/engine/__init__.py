"""Training engine: losses, optimizer and schedules, the one-device trainer."""
