"""Logging and experiment tracking (reference utilities.py:36-58, main.py:286-302).

 - :func:`create_logging`: auto-numbered ``NNNN.log`` files plus a console echo;
 - :class:`MetricLogger`: wandb when it imports and ``WANDB_MODE`` is not
   ``disabled``, else one JSON object per line in ``metrics.jsonl``.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional


def create_folder(fd: str) -> None:
    os.makedirs(fd, exist_ok=True)


def get_filename(path: str) -> str:
    """The file name of ``path`` (links resolved) without its extension."""
    return os.path.splitext(os.path.basename(os.path.realpath(path)))[0]


def get_sub_filepaths(folder: str):
    """Every file under ``folder``, recursively, in ``os.walk``'s order."""
    paths = []
    for root, _, files in os.walk(folder):
        for name in files:
            paths.append(os.path.join(root, name))
    return paths


def create_logging(log_dir: str, filemode: str = "w") -> logging.Logger:
    """Log to the first free ``NNNN.log`` in ``log_dir`` and echo INFO and
    above to the console (utilities.py:36-58)."""
    create_folder(log_dir)
    i1 = 0
    while os.path.isfile(os.path.join(log_dir, f"{i1:04d}.log")):
        i1 += 1
    logging.basicConfig(
        level=logging.DEBUG,
        format="%(asctime)s %(filename)s[line:%(lineno)d] %(levelname)s %(message)s",
        datefmt="%a, %d %b %Y %H:%M:%S",
        filename=os.path.join(log_dir, f"{i1:04d}.log"),
        filemode=filemode,
    )
    console = logging.StreamHandler()
    console.setLevel(logging.INFO)
    console.setFormatter(logging.Formatter("%(name)-12s: %(levelname)-8s %(message)s"))
    logging.getLogger("").addHandler(console)
    return logging.getLogger("")


class MetricLogger:
    """wandb-or-JSONL metric sink: ``log({"test/mAP": 0.4}, step=10)``."""

    def __init__(self, project: str = "audioset-convnext-torch", run_name: Optional[str] = None,
                 out_dir: str = ".", config: Optional[Dict[str, Any]] = None):
        self._wandb = None
        self._file = None
        if os.environ.get("WANDB_MODE", "") != "disabled":
            try:
                import wandb  # type: ignore

                wandb.init(project=project, name=run_name, config=config or {})
                self._wandb = wandb
            except Exception:
                self._wandb = None
        if self._wandb is None:
            create_folder(out_dir)
            self._file = open(os.path.join(out_dir, "metrics.jsonl"), "a")
            if config:
                self._file.write(json.dumps({"_config": config, "_ts": time.time()}) + "\n")

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
        elif self._file is not None:
            rec = dict(metrics)
            rec["_step"] = step
            rec["_ts"] = time.time()
            self._file.write(json.dumps(rec) + "\n")
            self._file.flush()

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()
        if self._file is not None:
            self._file.close()
            self._file = None
