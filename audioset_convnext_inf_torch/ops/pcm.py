"""int16 PCM decode on the device.

int16 waveforms cross to the card at half the bytes of float32 and decode
there as ``x * 1/32767`` in float32: bit-identical to the JAX package's
decode (its ``ops/pcm.py``) for every int16 value.
"""

from __future__ import annotations

import torch

from audioset_convnext_inf_torch.config import INT16_SCALE


def decode_pcm_if_int16(waveform: torch.Tensor) -> torch.Tensor:
    """int16 -> float32 in [-1, 1] (x * 1/32767); other dtypes unchanged."""
    if waveform.dtype == torch.int16:
        return waveform.to(torch.float32) * INT16_SCALE
    return waveform
