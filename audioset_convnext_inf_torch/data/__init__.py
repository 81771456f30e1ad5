"""Data plane: audio I/O, the AudioSet HDF5 dataset, the evaluation
sampler, and the prefetching loader with host-to-card double buffering.
h5py is imported only where an HDF5 file is opened."""

from audioset_convnext_inf_torch.data.audio_io import (
    float32_to_int16,
    int16_to_float32,
    pad_or_truncate,
    read_wav,
    resample_poly,
)
from audioset_convnext_inf_torch.data.hdf5_dataset import AudioSetDataset, collate, load_index
from audioset_convnext_inf_torch.data.loader import DataLoader, device_prefetch
from audioset_convnext_inf_torch.data.samplers import EvaluateSampler

__all__ = [
    "AudioSetDataset",
    "DataLoader",
    "EvaluateSampler",
    "collate",
    "device_prefetch",
    "float32_to_int16",
    "int16_to_float32",
    "load_index",
    "pad_or_truncate",
    "read_wav",
    "resample_poly",
]
