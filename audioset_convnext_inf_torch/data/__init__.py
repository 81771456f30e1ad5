"""Data plane: audio I/O (WAV and resampling through the port's host
library, FLAC through its decoder), the AudioSet HDF5 dataset (waveforms or
Kaldi fbanks), the train and evaluation samplers, the blacklist, the
prefetching loader and ``device_prefetch``, dataset packing
(``data/pack.py``), and the AudioCaps dataset (``data/audiocaps.py``). h5py
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
from audioset_convnext_inf_torch.data.loader import DataLoader, device_prefetch
from audioset_convnext_inf_torch.data.pack import (
    combine_indexes,
    create_indexes,
    pack_waveforms_to_hdf5,
    read_metadata,
    split_unbalanced_csv_to_partial_csvs,
)
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
    "combine_indexes",
    "create_indexes",
    "dcase2017_task4_ids",
    "device_prefetch",
    "float32_to_int16",
    "int16_to_float32",
    "load_index",
    "pack_waveforms_to_hdf5",
    "pad_or_truncate",
    "read_audio",
    "read_black_list",
    "read_flac",
    "read_metadata",
    "read_wav",
    "resample_poly",
    "split_unbalanced_csv_to_partial_csvs",
    "write_black_list",
]
