"""Data plane: audio I/O (WAV, and FLAC through the port's decoder), the
AudioSet HDF5 dataset, the train and evaluation samplers, the blacklist, the
prefetching loader, and the AudioCaps dataset (``data/audiocaps.py``). h5py
is imported only where an HDF5 file is opened."""

from audioset_convnext_inf_torch.data.audio_io import (
    float32_to_int16,
    int16_to_float32,
    pad_or_truncate,
    read_audio,
    read_flac,
    read_wav,
    resample_poly,
)
from audioset_convnext_inf_torch.data.blacklist import dcase2017_task4_ids, write_black_list
from audioset_convnext_inf_torch.data.hdf5_dataset import AudioSetDataset, collate, load_index
from audioset_convnext_inf_torch.data.loader import DataLoader
from audioset_convnext_inf_torch.data.samplers import (
    AlternateTrainSampler,
    BalancedTrainSampler,
    EvaluateSampler,
    TrainSampler,
    read_black_list,
)

__all__ = [
    "AlternateTrainSampler",
    "AudioSetDataset",
    "BalancedTrainSampler",
    "DataLoader",
    "EvaluateSampler",
    "TrainSampler",
    "collate",
    "dcase2017_task4_ids",
    "float32_to_int16",
    "int16_to_float32",
    "load_index",
    "pad_or_truncate",
    "read_audio",
    "read_black_list",
    "read_flac",
    "read_wav",
    "resample_poly",
    "write_black_list",
]
