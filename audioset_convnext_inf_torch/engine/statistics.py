"""Training-run metric history (reference utilities.StatisticsContainer:273-305).

Pickles ``{'bal': [...], 'test': [...]}``, one dict of statistics per
evaluation, to ``statistics_path`` and to a timestamped backup beside it;
on resume, keeps the evaluations up to the resumed iteration. The pickle is
the JAX package's, so either package reads the other's history.
"""

from __future__ import annotations

import datetime
import logging
import os
import pickle
from typing import Dict, List


class StatisticsContainer:
    def __init__(self, statistics_path: str):
        self.statistics_path = statistics_path
        self.backup_statistics_path = "{}_{}.pkl".format(
            os.path.splitext(self.statistics_path)[0],
            datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S"),
        )
        self.statistics_dict: Dict[str, List[dict]] = {"bal": [], "test": []}

    def append(self, iteration: int, statistics: dict, data_type: str) -> None:
        statistics = dict(statistics)
        statistics["iteration"] = iteration
        self.statistics_dict[data_type].append(statistics)

    def dump(self) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(self.statistics_path)), exist_ok=True)
        for path in (self.statistics_path, self.backup_statistics_path):
            with open(path, "wb") as f:
                pickle.dump(self.statistics_dict, f)
        logging.info("    Dump statistics to %s", self.statistics_path)

    def load_state_dict(self, resume_iteration: int) -> None:
        """Read the history and keep the evaluations at or before
        ``resume_iteration``."""
        with open(self.statistics_path, "rb") as f:
            statistics_dict = pickle.load(f)
        resumed: Dict[str, List[dict]] = {"bal": [], "test": []}
        for key, stats in statistics_dict.items():
            resumed.setdefault(key, []).extend(
                s for s in stats if s["iteration"] <= resume_iteration)
        self.statistics_dict = resumed
