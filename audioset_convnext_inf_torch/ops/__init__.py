"""The frontend, PCM decode, the waveform augmentations, the Kaldi fbank and
the fused block kernels."""

from audioset_convnext_inf_torch.ops.frontend import (
    LogMelFrontend,
    frame_signal,
    hann_window_periodic,
    log_mel_spectrogram,
    mel_filterbank,
    power_spectrogram,
)

__all__ = [
    "LogMelFrontend",
    "frame_signal",
    "hann_window_periodic",
    "log_mel_spectrogram",
    "mel_filterbank",
    "power_spectrogram",
]
