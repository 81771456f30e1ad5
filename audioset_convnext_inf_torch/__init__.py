"""PyTorch port of the AudioSet ConvNeXt audio tagger, for NVIDIA Hopper.

The same model as the JAX package beside it (kept as the reference): a
32 kHz waveform becomes a log-mel spectrogram, runs through the ConvNeXt
trunk, and yields 527 AudioSet probabilities, 768-d scene embeddings and
768x31x7 frame embeddings. The fused ConvNeXt
block is a CUDA kernel written for sm_90a (``csrc/fused_block.cu``).

Public API: :func:`audioset_convnext_inf_torch.models.convnext_tiny` et al.
and :class:`audioset_convnext_inf_torch.models.ConvNeXt`. Models run on the
card unless built with ``device="cpu"``.
"""

__version__ = "0.1.0"
