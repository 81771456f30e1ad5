"""Batch-meta samplers with resumable state.

The port's counterpart of the JAX package's ``data/samplers.py``
(reference utils/data_generator.py:126-501):

 - :class:`TrainSampler` - infinite uniform-shuffle sampler;
 - :class:`BalancedTrainSampler` - class-queue round robin with per-class
   pointers (equal sampling across the 527 classes);
 - :class:`AlternateTrainSampler` - alternates the two per batch;
 - :class:`EvaluateSampler` - finite sequential batches with targets.

They draw from ``np.random.RandomState(seed)`` in the JAX package's order,
so one seed and one index give the same batch metas in both packages. The
train samplers' ``state_dict`` / ``load_state_dict`` carry the MT19937
state, so a resumed run draws the batches the uninterrupted one would
have, and honour a blacklist CSV of YouTube ids.

Each sampler is built from an index HDF5 path, or with ``from_index`` from
an index already in memory (``load_index``'s dict: ``audio_names``,
``hdf5_paths``, ``indexes_in_hdf5``, ``targets``).
"""

from __future__ import annotations

import csv
from typing import Iterator, List, Optional

import numpy as np

from audioset_convnext_inf_torch.data.hdf5_dataset import load_index


def read_black_list(black_list_csv: str) -> List[str]:
    with open(black_list_csv, "r") as fr:
        return [line[0] for line in csv.reader(fr)]


def _rng_state(rs: np.random.RandomState) -> dict:
    """MT19937 state as a plain dict (what a checkpoint pickles)."""
    name, keys, pos, has_gauss, cached = rs.get_state()
    return {"name": name, "keys": np.asarray(keys).copy(), "pos": int(pos),
            "has_gauss": int(has_gauss), "cached_gaussian": float(cached)}


def _restore_rng(rs: np.random.RandomState, state: Optional[dict]) -> None:
    if state is None:  # a checkpoint without the RNG state keeps the seed's
        return
    rs.set_state((str(state["name"]), np.asarray(state["keys"], np.uint32),
                  int(state["pos"]), int(state["has_gauss"]),
                  float(state["cached_gaussian"])))


class _Base:
    def __init__(self, indexes_hdf5_path: str, batch_size: int,
                 black_list_csv: Optional[str] = None, random_seed: int = 1234):
        self._init(load_index(indexes_hdf5_path), batch_size, black_list_csv, random_seed)

    @classmethod
    def from_index(cls, index: dict, batch_size: int, black_list_csv: Optional[str] = None,
                   random_seed: int = 1234):
        """The sampler over an index already in memory."""
        sampler = cls.__new__(cls)
        sampler._init(index, batch_size, black_list_csv, random_seed)
        return sampler

    def _init(self, index: dict, batch_size: int, black_list_csv: Optional[str],
              random_seed: int) -> None:
        self.batch_size = batch_size
        self.random_state = np.random.RandomState(random_seed)
        self.black_list_names = set(read_black_list(black_list_csv)) if black_list_csv else set()
        self.audio_names = index["audio_names"]
        self.hdf5_paths = index["hdf5_paths"]
        self.indexes_in_hdf5 = index["indexes_in_hdf5"]
        self.targets = index["targets"]
        self.audios_num, self.classes_num = self.targets.shape

    def _blacklisted(self, index: int) -> bool:
        # The blacklist holds bare 11-character YouTube ids. The id is taken
        # from whichever audio-name convention the index uses: PANN-style
        # "Y<ytid>.wav" (16 characters), else its first 11 characters (a bare
        # id, or "<ytid>_<start>_<end>.<ext>").
        name = self.audio_names[index]
        if len(name) == 16 and name[0] == "Y" and name.endswith(".wav"):
            ytid = name[1:12]
        else:
            ytid = name[:11]
        return ytid in self.black_list_names

    def _meta(self, index: int) -> dict:
        return {
            "hdf5_path": self.hdf5_paths[index],
            "index_in_hdf5": int(self.indexes_in_hdf5[index]),
        }

    def __iter__(self) -> Iterator[List[dict]]:
        while True:
            batch_meta = []
            while len(batch_meta) < self.batch_size:
                index = self._next_index()
                if self._blacklisted(index):
                    continue
                batch_meta.append(self._meta(index))
            yield batch_meta


class TrainSampler(_Base):
    """Infinite uniform sampler (data_generator.py:163-228)."""

    def _init(self, *args) -> None:
        super()._init(*args)
        # epoch permutations are replaced, never shuffled in place (the same
        # RNG stream), so a state_dict snapshot can share the array
        self.indexes = self.random_state.permutation(self.audios_num)
        self.pointer = 0

    def _next_index(self) -> int:
        index = self.indexes[self.pointer]
        self.pointer += 1
        if self.pointer >= self.audios_num:
            self.pointer = 0
            self.indexes = self.random_state.permutation(self.indexes)
        return index

    def state_dict(self) -> dict:
        # the permutation is shared, not copied: the prefetching loader
        # snapshots every batch, and wraps replace the array
        return {"indexes": self.indexes, "pointer": self.pointer,
                "rng": _rng_state(self.random_state)}

    def load_state_dict(self, state: dict) -> None:
        self.indexes = np.asarray(state["indexes"]).copy()
        self.pointer = state["pointer"]
        _restore_rng(self.random_state, state.get("rng"))


class BalancedTrainSampler(_Base):
    """Class-balanced sampler (data_generator.py:231-331)."""

    def _init(self, *args) -> None:
        super()._init(*args)
        self.samples_num_per_class = np.sum(self.targets, axis=0)
        # per-class permutations are replaced on wrap, never mutated in place
        self.indexes_per_class = [
            self.random_state.permutation(np.where(self.targets[:, k] == 1)[0])
            for k in range(self.classes_num)
        ]
        self.queue: List[int] = []
        self.pointers_of_classes = [0] * self.classes_num

    def _expand_queue(self) -> None:
        classes_set = np.arange(self.classes_num).tolist()
        self.random_state.shuffle(classes_set)
        self.queue += classes_set

    def _next_index(self) -> int:
        # classes with no positive sample are skipped
        while True:
            if not self.queue:
                self._expand_queue()
            class_id = self.queue.pop(0)
            if self.samples_num_per_class[class_id] > 0:
                break
        pointer = self.pointers_of_classes[class_id]
        self.pointers_of_classes[class_id] += 1
        index = self.indexes_per_class[class_id][pointer]
        if self.pointers_of_classes[class_id] >= self.samples_num_per_class[class_id]:
            self.pointers_of_classes[class_id] = 0
            self.indexes_per_class[class_id] = self.random_state.permutation(
                self.indexes_per_class[class_id])
        return index

    def state_dict(self) -> dict:
        # the per-class arrays are shared (wraps replace them); the lists are
        # copied; the RNG state makes queue refills and reshuffles resume exactly
        return {
            "indexes_per_class": list(self.indexes_per_class),
            "queue": list(self.queue),
            "pointers_of_classes": list(self.pointers_of_classes),
            "rng": _rng_state(self.random_state),
        }

    def load_state_dict(self, state: dict) -> None:
        self.indexes_per_class = [np.asarray(a).copy() for a in state["indexes_per_class"]]
        self.queue = list(state["queue"])
        self.pointers_of_classes = list(state["pointers_of_classes"])
        _restore_rng(self.random_state, state.get("rng"))


class AlternateTrainSampler(_Base):
    """Alternates balanced and uniform batches (data_generator.py:334-448);
    the two samplers each start from ``random_seed``."""

    def _init(self, index, batch_size, black_list_csv, random_seed) -> None:
        self.sampler1 = TrainSampler.from_index(index, batch_size, black_list_csv, random_seed)
        self.sampler2 = BalancedTrainSampler.from_index(index, batch_size, black_list_csv,
                                                        random_seed)
        self.batch_size = batch_size
        self.count = 0

    def __iter__(self) -> Iterator[List[dict]]:
        while True:
            self.count += 1
            sampler = self.sampler1 if self.count % 2 == 0 else self.sampler2
            batch_meta = []
            while len(batch_meta) < self.batch_size:
                index = sampler._next_index()
                if sampler._blacklisted(index):
                    continue
                batch_meta.append(sampler._meta(index))
            yield batch_meta

    def state_dict(self) -> dict:
        return {
            "sampler1": self.sampler1.state_dict(),
            "sampler2": self.sampler2.state_dict(),
            "count": self.count,
        }

    def load_state_dict(self, state: dict) -> None:
        self.sampler1.load_state_dict(state["sampler1"])
        self.sampler2.load_state_dict(state["sampler2"])
        self.count = state.get("count", 0)


class EvaluateSampler:
    """Finite sequential batches of metas, each with its target."""

    def __init__(self, indexes_hdf5_path: str, batch_size: int):
        self._init(load_index(indexes_hdf5_path), batch_size)

    @classmethod
    def from_index(cls, index: dict, batch_size: int) -> "EvaluateSampler":
        """The sampler over an index already in memory."""
        sampler = cls.__new__(cls)
        sampler._init(index, batch_size)
        return sampler

    def _init(self, index: dict, batch_size: int) -> None:
        self.batch_size = batch_size
        self.audio_names = index["audio_names"]
        self.hdf5_paths = index["hdf5_paths"]
        self.indexes_in_hdf5 = index["indexes_in_hdf5"]
        self.targets = index["targets"]
        self.audios_num = len(self.audio_names)

    def __iter__(self) -> Iterator[List[dict]]:
        for start in range(0, self.audios_num, self.batch_size):
            end = min(start + self.batch_size, self.audios_num)
            yield [
                {
                    "audio_name": self.audio_names[i],
                    "hdf5_path": self.hdf5_paths[i],
                    "index_in_hdf5": int(self.indexes_in_hdf5[i]),
                    "target": self.targets[i],
                }
                for i in range(start, end)
            ]
