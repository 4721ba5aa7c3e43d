"""Client-side load checkpointing (copy of
``dgraph_tpu/client/checkpoint.py``).

Equivalent of client/checkpoint.go:29-95: per-source-file watermarks
persisted client-side so an interrupted bulk load resumes where it left
off.  The reference stores marks in a client badger; here a JSON file
updated atomically.  Contract: the loader calls `begin(file, line_no)`
before submitting a batch ending at line_no and `done(file, line_no)`
after the server acks it; `done_until(file)` after restart says which
lines to skip.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict

from dgraph_tpu_torch.utils.watermark import WaterMark


class SyncMarks:
    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, "checkpoints.json")
        self._marks: Dict[str, WaterMark] = {}
        self._persisted: Dict[str, int] = {}
        self._lock = threading.Lock()
        if os.path.exists(self.path):
            with open(self.path) as f:
                self._persisted = {k: int(v) for k, v in json.load(f).items()}

    def _wm(self, file: str) -> WaterMark:
        with self._lock:
            wm = self._marks.get(file)
            if wm is None:
                wm = self._marks[file] = WaterMark(file)
                base = self._persisted.get(file, 0)
                if base:
                    wm.begin(base)
                    wm.done(base)
            return wm

    def done_until(self, file: str) -> int:
        """Highest line index fully applied in a previous or current run."""
        return max(self._persisted.get(file, 0), self._wm(file).done_until())

    def begin(self, file: str, line_no: int) -> None:
        self._wm(file).begin(line_no)

    def done(self, file: str, line_no: int) -> None:
        wm = self._wm(file)
        wm.done(line_no)
        self._persist(file, wm.done_until())

    def _persist(self, file: str, mark: int) -> None:
        with self._lock:
            if mark <= self._persisted.get(file, 0):
                return
            self._persisted[file] = mark
            from dgraph_tpu_torch.utils.atomicio import atomic_write_file

            # fsync'd tmp+replace: a crash mid-persist must keep the OLD
            # checkpoint (replaying a few lines is safe; a torn JSON file
            # would abort the next resume entirely)
            atomic_write_file(
                self.path, json.dumps(self._persisted).encode()
            )
