"""Experiment logging: a CSV row and a JSONL event per ``log`` call, and
a snapshot of the code.

The port's copy of ``MetricsLogger`` and ``snapshot_code`` from
``pistoseg_tpu/core/logging.py``.  The CSV keeps the Lightning-CSV shape
(one row per epoch, columns sorted).  TensorBoard events are not written
yet: they come with the port of ``core/tboard.py`` (ROADMAP item 13), and
each logger says so when it is made.
"""

from __future__ import annotations

import csv
import json
import shutil
import time
from pathlib import Path
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, log_dir: str | Path, stage: str):
        self.dir = Path(log_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.stage = stage
        self.csv_path = self.dir / f"{stage}_metrics.csv"
        self.jsonl_path = self.dir / f"{stage}_events.jsonl"
        self._fieldnames: Optional[list] = None
        print(f"[{stage}] TensorBoard events are not written by the PyTorch port "
              f"yet (ROADMAP item 13); metrics go to {self.csv_path.name} and "
              f"{self.jsonl_path.name}")

    def log(self, metrics: Dict) -> None:
        row = {k: (float(v) if hasattr(v, "__float__") else v) for k, v in metrics.items()}
        row["wall_time"] = time.time()
        with self.jsonl_path.open("a") as f:
            f.write(json.dumps(row) + "\n")
        write_header = False
        if self._fieldnames is None:
            self._fieldnames = sorted(row.keys())
            write_header = not self.csv_path.exists()
        with self.csv_path.open("a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fieldnames, extrasaction="ignore")
            if write_header:
                w.writeheader()
            w.writerow(row)


def snapshot_code(log_dir: str | Path) -> Path:
    """Copy the package's sources into ``{log_dir}/code`` for experiment
    provenance (reference behaviour: ``mosaic_train.py:89-92``)."""
    src = Path(__file__).resolve().parents[1]
    dst = Path(log_dir) / "code" / src.name
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("__pycache__", "*.so"))
    return dst
