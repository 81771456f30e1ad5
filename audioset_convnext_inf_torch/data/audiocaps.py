"""The AudioCaps dataset (reference utils/audiocaps.py:30-778), offline.

The port's copy of the JAX package's ``data/audiocaps.py``: a columnar
caption and audio dataset with the reference's access surface:

 - ``AudioCaps(root, subset, with_tags=...)`` with subsets train/val/test
   and ``CAPTIONS_PER_AUDIO = {train: 1, val: 5, test: 5}``
 - ``at(idx, column)`` columnar access (audio, captions, tags, fname, ...)
 - ``__getitem__`` -> {'audio', 'captions'[, 'tags']}, optional transform
 - audio under ``<root>/AUDIOCAPS_32000Hz/audio/<subset>/`` as
   ``{youtube_id}_{start_seconds}.flac``, decoded by the port's FLAC
   decoder (``data/flac.py``)

The reference's youtube-dl + ffmpeg download pipeline (audiocaps.py:510-778)
is :func:`prepare_audiocaps_subset` / :func:`download_and_extract_from_youtube`,
with the commands built by pure functions (:func:`youtube_url_command`,
:func:`ffmpeg_extract_command`) and the runners injectable, so the pipeline
is tested without a network. Metadata CSVs (``<subset>.csv`` with
audiocap_id, youtube_id, start_time, caption) follow the official AudioCaps
release; tags come from an optional ``<subset>_tags.csv`` (youtube_id ->
AudioSet mids) mapped through class_labels_indices.csv.
"""

from __future__ import annotations

import csv
import os
import os.path as osp
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from audioset_convnext_inf_torch.data.audio_io import read_audio
from audioset_convnext_inf_torch.labels import read_audioset_label_tags


# Official metadata locations (reference audiocaps.py:741-778).
AUDIOCAPS_LINKS = {
    subset: {
        "captions": {
            "url": f"https://raw.githubusercontent.com/cdjkim/audiocaps/master/dataset/{subset}.csv",
            "fname": f"{subset}.csv",
        }
    }
    for subset in ("train", "val", "test")
}
AUDIOSET_LINKS = {
    key: {
        "fname": f"{fname}.csv",
        "url": f"http://storage.googleapis.com/us_audioset/youtube_corpus/v1/csv/{fname}.csv",
    }
    for key, fname in (
        ("class_labels_indices", "class_labels_indices"),
        ("eval", "eval_segments"),
        ("balanced", "balanced_train_segments"),
        ("unbalanced", "unbalanced_train_segments"),
    )
}


def youtube_url_command(youtube_id: str, youtube_dl_path: str = "youtube-dl") -> List[str]:
    """youtube-dl invocation that resolves a clip's (video, audio) stream
    URLs (reference audiocaps.py:688-694)."""
    return [
        youtube_dl_path,
        "--youtube-skip-dash-manifest",
        "-g",
        f"https://www.youtube.com/watch?v={youtube_id}",
    ]


def ffmpeg_extract_command(
    audio_link: str,
    fpath_out: str,
    start_time: int,
    duration: float = 10.00096876,  # reference AUDIO_MAX_SEC (audiocaps.py:82)
    sr: int = 32000,
    n_channels: int = 1,
    target_format: str = "flac",
    acodec: str = "flac",
    ffmpeg_path: str = "ffmpeg",
) -> List[str]:
    """ffmpeg invocation that trims/transcodes the stream to a 10-s mono
    flac at ``sr`` (reference audiocaps.py:706-732, argument for argument)."""
    return [
        ffmpeg_path,
        "-i", audio_link,
        "-vn",
        "-f", target_format,
        "-acodec", acodec,
        "-ss", str(start_time),
        "-t", str(duration),
        "-ar", str(sr),
        "-ac", str(n_channels),
        fpath_out,
    ]


def download_and_extract_from_youtube(
    youtube_id: str,
    fpath_out: str,
    start_time: int,
    duration: float = 10.00096876,
    sr: int = 32000,
    n_channels: int = 1,
    target_format: str = "flac",
    acodec: str = "flac",
    youtube_dl_path: str = "youtube-dl",
    ffmpeg_path: str = "ffmpeg",
    run_output: Optional[Callable[[List[str]], bytes]] = None,
    run_call: Optional[Callable[[List[str]], int]] = None,
) -> bool:
    """Resolve stream URLs then trim-download one clip; True on success
    (reference _download_and_extract_from_youtube, audiocaps.py:673-738).
    ``run_output``/``run_call`` default to subprocess and are injectable for
    offline testing."""
    import subprocess

    run_output = run_output or subprocess.check_output
    run_call = run_call or subprocess.check_call
    try:
        output = run_output(youtube_url_command(youtube_id, youtube_dl_path))
    except Exception:
        return False
    lines = output.decode().split("\n")
    if len(lines) < 2:
        return False
    _video_link, audio_link = lines[:2]
    cmd = ffmpeg_extract_command(
        audio_link, fpath_out, start_time, duration, sr, n_channels,
        target_format, acodec, ffmpeg_path,
    )
    try:
        return run_call(cmd) == 0
    except Exception:
        return False


def _audio_file_valid(path: str) -> bool:
    """Validity probe for a cached clip (reference __check_file decodes via
    torchaudio): decode with soundfile when available, else check container
    magic + a non-trivial size (neither machine has soundfile)."""
    try:
        import soundfile as sf

        with sf.SoundFile(path) as f:
            return f.frames > 0
    except ImportError:
        try:
            with open(path, "rb") as f:
                magic = f.read(4)
            return magic in (b"fLaC", b"RIFF", b"OggS") and os.path.getsize(path) > 1024
        except OSError:
            return False
    except Exception:
        return False


def prepare_audiocaps_subset(
    root: str,
    subset: str,
    sample_rate: int = 32000,
    youtube_dl_path: str = "youtube-dl",
    ffmpeg_path: str = "ffmpeg",
    run_output: Optional[Callable[[List[str]], bytes]] = None,
    run_call: Optional[Callable[[List[str]], int]] = None,
    verbose: int = 0,
    validate_cache: Optional[Callable[[str], bool]] = None,
) -> Dict[str, int]:
    """Build ``<root>/AUDIOCAPS_<sr>Hz/audio/<subset>/`` from the official
    captions CSV (reference __prepare_data, audiocaps.py:510-671).

    The captions CSV must already sit at
    ``<root>/AUDIOCAPS_<sr>Hz/<subset>.csv`` (it is not fetched; the reference
    fetches it from AUDIOCAPS_LINKS). Existing files are skipped. Returns
    ``{"ok": n, "err": n, "skipped": n}``.
    """
    if subset not in AUDIOCAPS_LINKS:
        raise ValueError(f"unknown subset {subset!r}")
    dpath_data = osp.join(root, f"AUDIOCAPS_{sample_rate}Hz")
    captions_fpath = osp.join(dpath_data, AUDIOCAPS_LINKS[subset]["captions"]["fname"])
    if not osp.isfile(captions_fpath):
        raise FileNotFoundError(
            f"captions CSV not found at {captions_fpath}; download it from "
            f"{AUDIOCAPS_LINKS[subset]['captions']['url']}"
        )
    dpath_audio = osp.join(dpath_data, "audio", subset)
    os.makedirs(dpath_audio, exist_ok=True)

    counts = {"ok": 0, "err": 0, "skipped": 0}
    with open(captions_fpath) as f:
        for line in csv.DictReader(f):
            youtube_id, start_time = line["youtube_id"], line["start_time"]
            if not start_time.isdigit():
                raise RuntimeError(
                    f"start time {start_time!r} is not an integer "
                    f"(audiocap_id={line.get('audiocap_id')}, youtube_id={youtube_id})"
                )
            fpath = osp.join(dpath_audio, f"{youtube_id}_{start_time}.flac")
            if osp.isfile(fpath):
                if (validate_cache or _audio_file_valid)(fpath):
                    counts["skipped"] += 1
                    continue
                # truncated/corrupt leftover from an interrupted run: the
                # reference decodes and removes it (__check_file,
                # audiocaps.py:600-620) so the cache can self-repair
                os.remove(fpath)
            ok = download_and_extract_from_youtube(
                youtube_id, fpath, int(start_time), sr=sample_rate,
                youtube_dl_path=youtube_dl_path, ffmpeg_path=ffmpeg_path,
                run_output=run_output, run_call=run_call,
            )
            counts["ok" if ok else "err"] += 1
            if verbose:
                print(f"[{'ok' if ok else 'ERR'}] {youtube_id}_{start_time}")
    return counts


class AudioCapsItem:
    """Column-name constants (reference audiocaps.py:30-46)."""

    AUDIO = "audio"
    CAPTIONS = "captions"
    TAGS = "tags"
    FNAME = "fname"
    INDEX = "index"
    YOUTUBE_ID = "youtube_id"
    START_TIME = "start_time"


class AudioCaps:
    AUDIO_N_CHANNELS = 1
    CAPTIONS_PER_AUDIO = {"train": 1, "val": 5, "test": 5}
    SAMPLE_RATE = 32000
    SUBSETS = ("train", "val", "test")
    # the on-disk layout prepare_audiocaps_subset writes and the reference
    # uses (audiocaps.py:81): {youtube_id}_{start_seconds}.flac
    AUDIO_FILE_EXTENSION = "flac"

    def __init__(
        self,
        root: str = ".",
        subset: str = "train",
        download: bool = False,
        with_tags: bool = False,
        transform: Optional[Callable] = None,
        flat_captions: bool = False,
        exclude_removed_audio: bool = True,
        verbose: int = 0,
    ) -> None:
        if subset not in self.SUBSETS:
            raise ValueError(
                f"Invalid argument {subset} for AudioCaps. (expected one of {self.SUBSETS})"
            )
        if download:
            import shutil

            if not (shutil.which("youtube-dl") and shutil.which("ffmpeg")):
                raise RuntimeError(
                    "AudioCaps download requires youtube-dl/ffmpeg on PATH (and "
                    "network access); prepare the audio directory offline (see "
                    "prepare_audiocaps_subset) and pass download=False"
                )
            prepare_audiocaps_subset(root, subset, self.SAMPLE_RATE, verbose=verbose)
        self.__root = root
        self.__subset = subset
        self.__with_tags = with_tags
        self.__transform = transform
        self.__flat_captions = flat_captions
        self.__exclude_removed_audio = exclude_removed_audio
        self.__verbose = verbose
        self.__all_items: Dict[str, List[Any]] = {}
        self.__loaded = False
        self.__load_data()

    # -- paths --------------------------------------------------------------
    @property
    def __dpath_data(self) -> str:
        return osp.join(self.__root, f"AUDIOCAPS_{self.SAMPLE_RATE}Hz")

    @property
    def __dpath_audio_subset(self) -> str:
        return osp.join(self.__dpath_data, "audio", self.__subset)

    # -- public surface -----------------------------------------------------
    @property
    def column_names(self) -> List[str]:
        return list(self.__all_items.keys()) + [AudioCapsItem.AUDIO]

    @property
    def index_to_tagname(self) -> List[str]:
        return read_audioset_label_tags().labels

    @property
    def info(self) -> Dict[str, Any]:
        return {"dataset": "audiocaps", "subset": self.__subset, "size": len(self)}

    @property
    def shape(self) -> Tuple[int, ...]:
        return (len(self), len(self.column_names))

    def is_loaded(self) -> bool:
        return self.__loaded

    def set_transform(self, transform: Optional[Callable]) -> None:
        self.__transform = transform

    def at(self, idx: Union[int, slice], column: Optional[str] = None):
        """Columnar access; ``column=None`` returns the full item dict."""
        if column is None:
            return {c: self.at(idx, c) for c in self.column_names if c != "is_on_disk"}
        if column == AudioCapsItem.AUDIO:
            if isinstance(idx, slice):
                return [self.at(i, column) for i in range(*idx.indices(len(self)))]
            fpath = osp.join(self.__dpath_audio_subset, self.__all_items["fname"][idx])
            audio, sr = read_audio(fpath, target_sr=None)
            if sr != self.SAMPLE_RATE:
                raise RuntimeError(
                    f"Invalid sample rate in {fpath} (expected {self.SAMPLE_RATE}, found {sr})"
                )
            return audio
        return self.__all_items[column][idx]

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        item = {
            "audio": self.at(idx, AudioCapsItem.AUDIO),
            "captions": self.at(idx, AudioCapsItem.CAPTIONS),
        }
        if self.__with_tags:
            item["tags"] = self.at(idx, AudioCapsItem.TAGS)
        if self.__transform is not None:
            item = self.__transform(item)
        return item

    def __len__(self) -> int:
        return len(self.__all_items.get("captions", []))

    def __repr__(self) -> str:
        return f"AudioCaps(subset={self.__subset}, size={len(self)})"

    # -- loading ------------------------------------------------------------
    def __load_data(self) -> None:
        csv_path = osp.join(self.__dpath_data, f"{self.__subset}.csv")
        if not osp.exists(csv_path):
            raise FileNotFoundError(
                f"AudioCaps metadata not found at {csv_path}; expected the "
                "official <subset>.csv (audiocap_id,youtube_id,start_time,caption)"
            )
        rows: List[Dict[str, str]] = []
        with open(csv_path, newline="") as f:
            for row in csv.DictReader(f):
                rows.append(row)

        # group captions per (youtube_id, start_time) clip
        grouped: Dict[Tuple[str, str], Dict[str, Any]] = {}
        order: List[Tuple[str, str]] = []
        for row in rows:
            key = (row["youtube_id"], row["start_time"])
            if key not in grouped:
                grouped[key] = {
                    "youtube_id": row["youtube_id"],
                    "start_time": row["start_time"],
                    "captions": [],
                    "audiocap_ids": [],
                }
                order.append(key)
            grouped[key]["captions"].append(row["caption"])
            grouped[key]["audiocap_ids"].append(row.get("audiocap_id"))

        tags_map = self.__load_tags() if self.__with_tags else {}
        items: Dict[str, List[Any]] = {
            "index": [], "fname": [], "youtube_id": [], "start_time": [],
            "captions": [], "audiocap_ids": [], "tags": [], "is_on_disk": [],
        }
        i = 0
        for key in order:
            g = grouped[key]
            # {youtube_id}_{start_seconds}.flac - the layout
            # prepare_audiocaps_subset writes and the reference reads
            # (audiocaps.py:397: raw integer seconds, no ms conversion)
            fname = (f"{g['youtube_id']}_{int(float(g['start_time']))}"
                     f".{self.AUDIO_FILE_EXTENSION}")
            on_disk = osp.exists(osp.join(self.__dpath_audio_subset, fname))
            if self.__exclude_removed_audio and not on_disk:
                # ~7% of AudioCaps is no longer downloadable; the reference
                # default drops clips missing on disk (audiocaps.py:396-408)
                # so full-dataset passes don't crash on the first gap
                continue
            items["index"].append(i)
            items["fname"].append(fname)
            items["youtube_id"].append(g["youtube_id"])
            items["start_time"].append(g["start_time"])
            items["captions"].append(g["captions"])
            items["audiocap_ids"].append(g["audiocap_ids"])
            items["tags"].append(tags_map.get(g["youtube_id"], []))
            items["is_on_disk"].append(on_disk)
            i += 1

        if self.__flat_captions and self.CAPTIONS_PER_AUDIO[self.__subset] > 1:
            flat: Dict[str, List[Any]] = {k: [] for k in items}
            for i in range(len(items["captions"])):
                for cap in items["captions"][i]:
                    for k in items:
                        flat[k].append([cap] if k == "captions" else items[k][i])
            items = flat

        self.__all_items = items
        self.__loaded = True

    def __load_tags(self) -> Dict[str, List[int]]:
        """youtube_id -> AudioSet class indexes, from <subset>_tags.csv
        (columns: youtube_id, mids 'mid1;mid2;...')."""
        path = osp.join(self.__dpath_data, f"{self.__subset}_tags.csv")
        if not osp.exists(path):
            return {}
        id_to_ix = read_audioset_label_tags().id_to_ix
        out: Dict[str, List[int]] = {}
        with open(path, newline="") as f:
            for row in csv.DictReader(f):
                mids = [m for m in row.get("mids", "").split(";") if m]
                out[row["youtube_id"]] = [id_to_ix[m] for m in mids if m in id_to_ix]
        return out


def tag_2_onehot(tag_list_one_item: List[int], num_classes: int = 527) -> np.ndarray:
    """List of class indexes -> (1, num_classes) one-hot
    (aac_datasets_utils.py:24-32)."""
    onehot = np.zeros((1, num_classes), np.float32)
    for t in tag_list_one_item:
        onehot[0, int(t)] = 1.0
    return onehot


class BasicCollate:
    """Pad-to-longest audio collate + optional one-hot tags
    (aac_datasets_utils.py:35-93)."""

    def __init__(self, audio_fill_value: float = 0.0, with_tags: bool = False,
                 num_tag_classes: int = 527):
        self.audio_fill_value = audio_fill_value
        self.with_tags = with_tags
        self.num_tag_classes = num_tag_classes

    def __call__(self, batch: List[Dict[str, Any]]) -> Dict[str, Any]:
        if len(batch) == 0:
            raise ValueError("Cannot collate an empty list of items.")
        audios = [np.asarray(item["audio"], np.float32) for item in batch]
        target_length = max(a.shape[-1] for a in audios)
        padded = np.stack([
            np.pad(a, (0, target_length - a.shape[-1]), constant_values=self.audio_fill_value)
            for a in audios
        ])
        out: Dict[str, Any] = {
            "audio": padded,
            "captions": [item["captions"] for item in batch],
        }
        if self.with_tags:
            out["tags"] = np.concatenate(
                [tag_2_onehot(item["tags"], self.num_tag_classes) for item in batch]
            )
        return out
