"""Utilities: logging and experiment tracking, profiling, the compilation
cache, the host audio library (``utils/native.py``) and the host build
helper (``utils/host_build.py``)."""

from audioset_convnext_inf_torch.utils.logging_utils import (
    MetricLogger,
    create_folder,
    create_logging,
    get_filename,
    get_sub_filepaths,
)
from audioset_convnext_inf_torch.utils.profiling import (
    count_flops,
    count_parameters,
    span,
    trace,
)

__all__ = [
    "create_logging",
    "create_folder",
    "get_filename",
    "get_sub_filepaths",
    "MetricLogger",
    "count_flops",
    "count_parameters",
    "span",
    "trace",
]
