"""Dataset build tooling: AudioSet segment CSVs -> packed waveform and index HDF5.

The port's counterpart of the JAX package's ``data/pack.py`` (reference
utils/dataset.py: ``split_unbalanced_csv_to_partial_csvs`` :29,
``download_wavs`` :63, ``pack_waveforms_to_hdf5`` :146), and the index files
the samplers and the Evaluator read. Clips are read through the port's
``data/audio_io.py::read_audio`` (WAV, or FLAC through the port's decoder)
and resampled and quantized by its host library (``utils/native.py``).
``h5py`` is imported where a file is written or read, not with this module.
"""

from __future__ import annotations

import logging
import os
import re
import shutil
import subprocess
from typing import Dict, List, Optional

import numpy as np

from audioset_convnext_inf_torch.config import CLIP_SAMPLES, NUM_CLASSES, SAMPLE_RATE
from audioset_convnext_inf_torch.data.audio_io import float32_to_int16, pad_or_truncate, read_audio
from audioset_convnext_inf_torch.labels import read_audioset_label_tags


def _clip_name(items: List[str]) -> str:
    """``{ytid}_{start}_{end}`` with the dots stripped and the ``_0000_`` ->
    ``_0_`` quirk (utilities.py:62-124)."""
    return "{}_{}_{}".format(items[0], items[1].replace(".", ""),
                             items[2].replace(".", "")).replace("_0000_", "_0_")


def read_metadata(csv_path: str, audio_dir: str, classes_num: int = NUM_CLASSES,
                  id_to_ix: Optional[dict] = None, audio_ext: str = ".flac") -> Dict[str, np.ndarray]:
    """An AudioSet segment CSV -> {'audio_name', 'target' (N, classes) bool},
    keeping the rows whose ``{ytid}_{start}_{end}{audio_ext}`` is in
    ``audio_dir`` (utilities.py:62-124)."""
    if id_to_ix is None:
        id_to_ix = read_audioset_label_tags().id_to_ix
    with open(csv_path, "r") as fr:
        lines = fr.readlines()[3:]
    audio_names: List[str] = []
    rows: List[List[str]] = []
    for line in lines:
        items = line.split(", ")
        name = _clip_name(items) + audio_ext
        if os.path.exists(os.path.join(audio_dir, name)):
            audio_names.append(name)
            rows.append(items)
    targets = np.zeros((len(audio_names), classes_num), dtype=bool)
    for n, items in enumerate(rows):
        for label_id in items[3].split('"')[1].split(","):
            targets[n, id_to_ix[label_id]] = 1
    return {"audio_name": np.array(audio_names), "target": targets}


def split_unbalanced_csv_to_partial_csvs(csv_path: str, out_dir: str,
                                         rows_per_file: int = 50000) -> List[str]:
    """Split the unbalanced-train CSV into parts of ``rows_per_file`` rows,
    each with the three header lines (dataset.py:29-60)."""
    os.makedirs(out_dir, exist_ok=True)
    with open(csv_path) as f:
        lines = f.readlines()
    head, body = lines[:3], lines[3:]
    paths = []
    for i in range(0, len(body), rows_per_file):
        part = os.path.join(out_dir, f"unbalanced_train_segments_part{i // rows_per_file:02d}.csv")
        with open(part, "w") as f:
            f.writelines(head + body[i:i + rows_per_file])
        paths.append(part)
    return paths


def pack_waveforms_to_hdf5(
    csv_path: str,
    audios_dir: str,
    waveforms_hdf5_path: str,
    sample_rate: int = SAMPLE_RATE,
    clip_samples: int = CLIP_SAMPLES,
    mini_data: int = 0,
    audio_ext: str = ".wav",
) -> str:
    """Pack the CSV's clips found in ``audios_dir`` into the reference's
    HDF5 schema (dataset.py:146-237): ``audio_name`` S20 (the bare YouTube
    id: the ``_<start>_<end><ext>`` suffix stripped, as the samplers,
    blacklists and exports key on it), ``waveform`` int16 (N, clip_samples)
    resampled to ``sample_rate`` and padded or cut, ``target`` bool, and the
    ``sample_rate`` attribute."""
    import h5py

    meta = read_metadata(csv_path, audios_dir, audio_ext=audio_ext)
    audio_names, targets = meta["audio_name"], meta["target"]
    if mini_data:
        audio_names, targets = audio_names[:mini_data], targets[:mini_data]
    os.makedirs(os.path.dirname(os.path.abspath(waveforms_hdf5_path)), exist_ok=True)
    n = len(audio_names)
    strip = re.compile(r"_\d+_\d+" + re.escape(audio_ext) + "$")
    with h5py.File(waveforms_hdf5_path, "w") as hf:
        hf.create_dataset("audio_name", shape=(n,), dtype="S20")
        hf.create_dataset("waveform", shape=(n, clip_samples), dtype=np.int16)
        hf.create_dataset("target", shape=(n, targets.shape[1]), dtype=bool)
        hf.attrs.create("sample_rate", data=sample_rate, dtype=np.int32)
        for i, name in enumerate(audio_names):
            audio, _ = read_audio(os.path.join(audios_dir, name), target_sr=sample_rate)
            hf["audio_name"][i] = strip.sub("", name).encode()
            hf["waveform"][i] = float32_to_int16(pad_or_truncate(audio, clip_samples))
            hf["target"][i] = targets[i]
    return waveforms_hdf5_path


def download_wavs(
    csv_path: str,
    audios_dir: str,
    mini_data: int = 0,
    downloader: str = "yt-dlp",
    ffmpeg: str = "ffmpeg",
    dry_run: bool = False,
) -> List[str]:
    """The download of a segment CSV's clips (dataset.py:63-143), as three
    commands per clip: fetch the whole audio, trim it with ffmpeg to the
    CSV's [start, end] at 32 kHz mono, remove the raw download (as the
    reference does at dataset.py:133). Returns every command. They run only
    when both tools are on ``PATH`` and ``dry_run`` is false; a clip whose
    WAV exists is skipped."""
    os.makedirs(audios_dir, exist_ok=True)
    with open(csv_path, "r") as fr:
        lines = fr.readlines()[3:]
    if mini_data:
        lines = lines[:mini_data]
    have_tools = shutil.which(downloader) and shutil.which(ffmpeg)
    commands: List[str] = []
    for line in lines:
        items = line.split(", ")
        ytid, start = items[0], float(items[1])
        duration = float(items[2]) - start
        raw = os.path.join(audios_dir, f"_{ytid}.raw_audio")
        final = os.path.join(audios_dir, _clip_name(items) + ".wav")
        dl = f'{downloader} -x -o "{raw}.%(ext)s" "https://www.youtube.com/watch?v={ytid}"'
        trim = f'{ffmpeg} -y -i "{raw}".* -ac 1 -ar 32000 -ss {start} -t {duration} "{final}"'
        cleanup = f'rm -f "{raw}".*'
        commands.extend([dl, trim, cleanup])
        if not dry_run and have_tools and not os.path.exists(final):
            for cmd in (dl, trim, cleanup):
                subprocess.run(cmd, shell=True, check=False)
    if not have_tools and not dry_run:
        logging.warning("%s/%s not found; returning %d commands without running them",
                        downloader, ffmpeg, len(commands))
    return commands


def create_indexes(waveforms_hdf5_path: str, indexes_hdf5_path: str) -> str:
    """The index HDF5 of one packed file: ``audio_name``, ``target``, the
    packed file's absolute path per row, and ``index_in_hdf5``."""
    import h5py

    with h5py.File(waveforms_hdf5_path, "r") as hr:
        n = len(hr["audio_name"])
        with h5py.File(indexes_hdf5_path, "w") as hw:
            hw.create_dataset("audio_name", data=hr["audio_name"][:])
            hw.create_dataset("target", data=hr["target"][:])
            hw.create_dataset("hdf5_path",
                              data=[os.path.abspath(waveforms_hdf5_path).encode()] * n)
            hw.create_dataset("index_in_hdf5", data=np.arange(n, dtype=np.int32))
    return indexes_hdf5_path


def combine_indexes(index_paths: List[str], out_path: str) -> str:
    """Concatenate index HDF5s (the full training set is many packed parts)."""
    import h5py

    keys = ("audio_name", "target", "hdf5_path", "index_in_hdf5")
    parts: Dict[str, list] = {k: [] for k in keys}
    for p in index_paths:
        with h5py.File(p, "r") as hf:
            for k in keys:
                parts[k].append(hf[k][:])
    with h5py.File(out_path, "w") as hw:
        for k in keys:
            hw.create_dataset(k, data=np.concatenate(parts[k]))
    return out_path
