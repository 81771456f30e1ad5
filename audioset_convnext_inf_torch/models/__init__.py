"""Model zoo: factories and the ConvNeXt module."""

from audioset_convnext_inf_torch.models.api import (
    MODEL_REGISTRY,
    ConvNeXt,
    convnext_atto,
    convnext_base,
    convnext_femto,
    convnext_nano,
    convnext_pico,
    convnext_small,
    convnext_tiny,
    create_model,
)

__all__ = [
    "ConvNeXt",
    "convnext_atto",
    "convnext_femto",
    "convnext_pico",
    "convnext_nano",
    "convnext_tiny",
    "convnext_small",
    "convnext_base",
    "create_model",
    "MODEL_REGISTRY",
]
