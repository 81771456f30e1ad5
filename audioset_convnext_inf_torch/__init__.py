"""PyTorch port of the AudioSet ConvNeXt audio tagger, for NVIDIA Hopper.

The same model as the JAX package beside it (kept as the reference): a
32 kHz waveform becomes a log-mel spectrogram, runs through the ConvNeXt
trunk, and yields 527 AudioSet probabilities, 768-d scene embeddings and
768x31x7 frame embeddings. The fused ConvNeXt
block is a CUDA kernel written for sm_90a (``csrc/fused_block.cu``).

Public API (also here, loaded on first use):
:func:`audioset_convnext_inf_torch.models.convnext_tiny` et al., ``create_model``
and :class:`audioset_convnext_inf_torch.models.ConvNeXt`; the PANN zoo's
``PannModel``, ``create_pann_model`` and ``PANN_REGISTRY``; ``ConvNeXtConfig``;
``read_audioset_label_tags``. Models run on the card unless built with ``device="cpu"``.
"""

from audioset_convnext_inf_torch.version import __version__  # noqa: F401


_MODEL_NAMES = ("ConvNeXt", "convnext_tiny", "convnext_nano", "convnext_atto", "convnext_femto",
                "convnext_pico", "convnext_small", "convnext_base", "create_model",
                "MODEL_REGISTRY")


def __getattr__(name):
    """The public API, imported on first use: importing the package loads no
    model code (a serving bundle's loader relies on it)."""
    if name in ("PannModel", "create_pann_model", "PANN_REGISTRY"):
        from audioset_convnext_inf_torch.models import pann

        return getattr(pann, name)
    if name in _MODEL_NAMES:
        from audioset_convnext_inf_torch.models import api

        return getattr(api, name)
    if name in ("ConvNeXtConfig", "FrontendConfig", "AugmentConfig"):
        from audioset_convnext_inf_torch import config

        return getattr(config, name)
    if name == "read_audioset_label_tags":
        from audioset_convnext_inf_torch.labels import read_audioset_label_tags

        return read_audioset_label_tags
    raise AttributeError(name)


__all__ = [
    "__version__",
    "ConvNeXt",
    "convnext_tiny",
    "create_model",
    "create_pann_model",
    "ConvNeXtConfig",
    "read_audioset_label_tags",
]
