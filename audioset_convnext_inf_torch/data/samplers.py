"""Batch-meta samplers.

The port's counterpart of the JAX package's ``data/samplers.py``; so far
only :class:`EvaluateSampler` (utils/data_generator.py:451-501). The three
training samplers and ``read_black_list`` come with the training CLI
(ROADMAP.md).
"""

from __future__ import annotations

from typing import Iterator, List

from audioset_convnext_inf_torch.data.hdf5_dataset import load_index


class EvaluateSampler:
    """Finite sequential batches of metas, each with its target."""

    def __init__(self, indexes_hdf5_path: str, batch_size: int):
        self.batch_size = batch_size
        idx = load_index(indexes_hdf5_path)
        self.audio_names = idx["audio_names"]
        self.hdf5_paths = idx["hdf5_paths"]
        self.indexes_in_hdf5 = idx["indexes_in_hdf5"]
        self.targets = idx["targets"]
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
