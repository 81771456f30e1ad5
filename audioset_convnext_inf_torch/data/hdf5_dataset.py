"""AudioSet HDF5 datasets (packed-waveform and index files).

The port's counterpart of the JAX package's ``data/hdf5_dataset.py``, on
the reference's on-disk schema (utils/dataset.py:193-199):

 - packed waveform HDF5: ``audio_name`` (S20), ``waveform`` (int16,
   (N, clip_samples)), ``target`` (bool, (N, 527)), attribute ``sample_rate``;
 - index HDF5: ``audio_name``, ``hdf5_path``, ``index_in_hdf5``, ``target``,
   the working set the samplers walk.

:class:`AudioSetDataset` maps a meta {'hdf5_path', 'index_in_hdf5'} to
{'audio_name', 'waveform' or 'fbank', 'target'} (utils/data_generator.py:
27-123). File handles are kept per (path, thread), since the loader reads
from a thread pool. ``h5py`` is imported where a file is opened, not with
this module.
"""

from __future__ import annotations

import threading
from typing import Dict

import numpy as np

from audioset_convnext_inf_torch.data.audio_io import decimate_resample, int16_to_float32


class AudioSetDataset:
    def __init__(self, sample_rate: int = 32000, training: bool = False,
                 use_kaldi_fbank: bool = False, keep_int16: bool = False):
        """``use_kaldi_fbank`` is the reference's use_torchaudio mode
        (data_generator.py:75-97): items carry a (T, 224) Kaldi fbank
        computed on the host (``ops/kaldi_fbank.py`` on CPU tensors) in
        place of the waveform.

        ``keep_int16`` ships the packed int16 samples as they are and the
        card decodes them (x * INT16_SCALE, bit-identical to the host
        decode): half the bytes of float32 per clip. Only honoured for plain
        32 kHz waveforms: decimation and the fbank consume host-side
        float32, and would otherwise run on 32767-times-scaled samples."""
        self.sample_rate = sample_rate
        self.training = training
        self.use_kaldi_fbank = use_kaldi_fbank
        self.keep_int16 = keep_int16 and sample_rate == 32000 and not use_kaldi_fbank
        self._local = threading.local()

    def _file(self, path: str):
        files: Dict[str, object] = self._local.__dict__.setdefault("files", {})
        f = files.get(path)
        if f is None:
            import h5py

            f = files[path] = h5py.File(path, "r")
        return f

    def __getitem__(self, meta: dict) -> dict:
        hf = self._file(meta["hdf5_path"])
        idx = meta["index_in_hdf5"]
        return self.clip_item(hf["audio_name"][idx].decode(), hf["waveform"][idx],
                              hf["target"][idx])

    def clip_item(self, audio_name: str, waveform: np.ndarray, target: np.ndarray) -> dict:
        """One packed clip (int16 samples at 32 kHz) -> the item: the decode,
        the decimation to ``sample_rate`` and, in the fbank mode, the fbank.
        The HDF5 route and in-memory datasets share it."""
        target = np.asarray(target).astype(np.float32)
        if self.keep_int16:
            return {"audio_name": audio_name, "waveform": np.asarray(waveform),  # the card decodes
                    "target": target}
        waveform = decimate_resample(int16_to_float32(waveform), self.sample_rate)
        if self.use_kaldi_fbank:
            import torch

            from audioset_convnext_inf_torch.ops.kaldi_fbank import kaldi_fbank

            fbank = kaldi_fbank(torch.from_numpy(waveform), sample_rate=self.sample_rate).numpy()
            return {"audio_name": audio_name, "fbank": fbank, "target": target}
        return {"audio_name": audio_name, "waveform": waveform, "target": target}

    def close(self):
        """Close the calling thread's file handles."""
        for f in self._local.__dict__.pop("files", {}).values():
            f.close()


def load_index(indexes_hdf5_path: str) -> dict:
    """An index HDF5 as numpy arrays (data_generator.py:150-156)."""
    import h5py

    with h5py.File(indexes_hdf5_path, "r") as hf:
        return {
            "audio_names": np.array([n.decode() for n in hf["audio_name"][:]]),
            "hdf5_paths": np.array([p.decode() for p in hf["hdf5_path"][:]]),
            "indexes_in_hdf5": hf["index_in_hdf5"][:],
            "targets": hf["target"][:].astype(np.float32),
        }


def collate(list_data_dict: list) -> dict:
    """Stack per-clip dicts into batched numpy arrays (numeric fields dense,
    unlike the reference's object-array collate, data_generator.py:504-526)."""
    out: dict = {}
    for key in list_data_dict[0]:
        vals = [d[key] for d in list_data_dict]
        out[key] = np.stack(vals) if isinstance(vals[0], np.ndarray) else np.array(vals)
    return out
