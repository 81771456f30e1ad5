"""Blacklist tooling (reference utils/create_black_list.py:11-53).

Builds an exclusion CSV of YouTube ids from DCASE2017-task4 style segment
lists; the train samplers read it (``samplers.read_black_list``) and skip
clips whose YouTube id is listed.
"""

from __future__ import annotations

import csv
import os
from typing import List


def dcase2017_task4_ids(csv_paths: List[str]) -> List[str]:
    """Unique YouTube ids, in order of first appearance, from DCASE2017
    task4 testing/evaluation set CSVs (tab- or comma-separated, the id in
    the first column).

    The first column is a segment file name like
    ``-5QrBL6MzLg_60.000_70.000.wav``; the blacklist keeps its first 11
    characters, the bare YouTube id (create_black_list.py:37), which the
    samplers match against any audio-name convention."""
    ids: List[str] = []
    seen = set()
    for path in csv_paths:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                first = line.replace("\t", ",").split(",")[0][0:11]
                if first and first not in seen:
                    seen.add(first)
                    ids.append(first)
    return ids


def write_black_list(ids: List[str], out_csv: str) -> str:
    """One id per row; returns ``out_csv``."""
    os.makedirs(os.path.dirname(os.path.abspath(out_csv)), exist_ok=True)
    with open(out_csv, "w", newline="") as f:
        writer = csv.writer(f)
        for id_ in ids:
            writer.writerow([id_])
    return out_csv
