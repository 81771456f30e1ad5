"""Utilities: logging and experiment tracking."""

from audioset_convnext_inf_torch.utils.logging_utils import MetricLogger, create_logging

__all__ = ["MetricLogger", "create_logging"]
