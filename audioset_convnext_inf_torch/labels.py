"""AudioSet label metadata.

The port's own copy of the JAX package's ``labels.py``: parses
``class_labels_indices.csv`` (527 classes) into the lookup maps the
reference exposes (utils/utilities.py:195-216). The CSV is the repository's
``metadata/class_labels_indices.csv``, found from this file's location, with
the ``AUDIOSET_CLASS_LABELS_CSV`` environment variable as an override.
"""

from __future__ import annotations

import csv
import os
from functools import lru_cache
from typing import Dict, List, NamedTuple


class LabelMaps(NamedTuple):
    labels: List[str]
    ids: List[str]
    lb_to_ix: Dict[str, int]
    ix_to_lb: Dict[int, str]
    id_to_ix: Dict[str, int]
    ix_to_id: Dict[int, str]

    @property
    def classes_num(self) -> int:
        return len(self.labels)


def default_csv_path() -> str:
    env = os.environ.get("AUDIOSET_CLASS_LABELS_CSV")
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(root, "metadata", "class_labels_indices.csv")


@lru_cache(maxsize=8)
def read_audioset_label_tags(csv_path: str | None = None) -> LabelMaps:
    """Read labels and mids from the AudioSet class CSV (a header, then 527 rows)."""
    path = csv_path or default_csv_path()
    with open(path, "r") as f:
        rows = list(csv.reader(f, delimiter=","))
    ids = [row[1] for row in rows[1:]]
    labels = [row[2] for row in rows[1:]]
    return LabelMaps(
        labels=labels,
        ids=ids,
        lb_to_ix={lb: i for i, lb in enumerate(labels)},
        ix_to_lb=dict(enumerate(labels)),
        id_to_ix={id_: i for i, id_ in enumerate(ids)},
        ix_to_id=dict(enumerate(ids)),
    )
