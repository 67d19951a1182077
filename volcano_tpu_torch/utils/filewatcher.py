"""Polling file watcher (counterpart of volcano_tpu/utils/filewatcher.py;
reference: pkg/filewatcher, an fsnotify wrapper). The scheduler's conf hot
reload uses it: a thread polls the file's mtime every ``interval`` seconds
and calls ``on_change`` when it moved."""

from __future__ import annotations

import logging
import os
import threading
from typing import Callable, Optional

log = logging.getLogger(__name__)


class FileWatcher:
    def __init__(self, path: str, on_change: Callable[[], None],
                 interval: float = 1.0):
        self.path = path
        self.on_change = on_change
        self.interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_mtime = self._mtime()

    def _mtime(self) -> float:
        try:
            return os.stat(self.path).st_mtime
        except OSError:
            return 0.0

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            mtime = self._mtime()
            if mtime != self._last_mtime:
                self._last_mtime = mtime
                try:
                    self.on_change()
                except Exception:
                    # the watcher outlives a failed callback; the next
                    # change calls it again
                    log.exception("file watcher callback for %s failed",
                                  self.path)

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name=f"filewatcher:{self.path}",
                daemon=True)
            self._thread.start()

    def stop(self, timeout: Optional[float] = None) -> None:
        """Stop polling; with ``timeout`` also wait that long for the
        thread to end."""
        self._stop.set()
        if timeout is not None and self._thread is not None:
            self._thread.join(timeout)
