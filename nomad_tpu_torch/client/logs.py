"""Size-based log rotation (reference: client/driver/logging/rotator.go).

Writes a stream to `<name>.N` files, rotating when a file reaches max_size
and deleting the oldest beyond max_files.

Copied from nomad_tpu/client/logs.py; only the imports differ.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Optional


class FileRotator:
    def __init__(self, path: str, base_name: str, max_files: int,
                 max_size_mb: int):
        self.path = path
        self.base_name = base_name
        self.max_files = max(1, max_files)
        self.max_size = max(1, max_size_mb) * 1024 * 1024
        self._lock = threading.Lock()
        self._index = self._find_latest_index()
        self._fh = None
        self._written = 0
        self._open_current()

    def _find_latest_index(self) -> int:
        pat = re.compile(re.escape(self.base_name) + r"\.(\d+)$")
        best = 0
        try:
            for name in os.listdir(self.path):
                m = pat.match(name)
                if m:
                    best = max(best, int(m.group(1)))
        except OSError:
            pass
        return best

    def _file(self, index: int) -> str:
        return os.path.join(self.path, f"{self.base_name}.{index}")

    def _open_current(self) -> None:
        os.makedirs(self.path, exist_ok=True)
        target = self._file(self._index)
        self._fh = open(target, "ab")
        self._written = self._fh.tell()

    def write(self, data: bytes) -> None:
        with self._lock:
            if self._fh is None:
                return
            if self._written + len(data) > self.max_size:
                self._rotate()
            self._fh.write(data)
            self._fh.flush()
            self._written += len(data)

    def _rotate(self) -> None:
        self._fh.close()
        self._index += 1
        self._open_current()
        # Prune files beyond max_files.
        oldest = self._index - self.max_files + 1
        pat = re.compile(re.escape(self.base_name) + r"\.(\d+)$")
        for name in os.listdir(self.path):
            m = pat.match(name)
            if m and int(m.group(1)) < oldest:
                try:
                    os.unlink(os.path.join(self.path, name))
                except OSError:
                    pass

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
