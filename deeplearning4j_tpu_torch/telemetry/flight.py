"""FlightRecorder — last-N records, dumped to JSON on a crash: the port of
``deeplearning4j_tpu/telemetry/flight.py`` (pure Python, copied).

Reference: deeplearning4j-core ``CrashReportingUtil``.  In the port the
serving tier records every failed request here with its whole lifecycle
timeline (``remote/scheduler.py``), so the post-mortem has the trace
without racing the timeline store's eviction; the training loops' step
records wait for ROADMAP A12.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from collections import deque
from typing import Deque, List, Optional

__all__ = ["FlightRecorder", "flight_recorder", "set_flight_recorder"]


class FlightRecorder:
    """Bounded ring of step records with crash-dump-to-JSON."""

    def __init__(self, capacity: int = 512,
                 dumpDir: Optional[str] = None):
        self.capacity = int(capacity)
        self._dumpDir = dumpDir
        self._records: Deque[dict] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.lastDumpPath: Optional[str] = None

    @property
    def dumpDir(self) -> str:
        # env resolved at DUMP time, not import time: the process-global
        # recorder is built when the package first imports, usually before
        # the user script gets a chance to set DL4J_TPU_FLIGHT_DIR
        return self._dumpDir or os.environ.get(
            "DL4J_TPU_FLIGHT_DIR") or tempfile.gettempdir()

    def record(self, **fields) -> None:
        rec = dict(fields)
        rec.setdefault("wall_time", time.time())
        with self._lock:
            self._records.append(rec)

    def snapshot(self) -> List[dict]:
        with self._lock:
            return list(self._records)

    def clear(self) -> None:
        with self._lock:
            self._records.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def dump(self, path: Optional[str] = None,
             reason: str = "unspecified") -> str:
        """Write the ring (oldest first) + the crash reason to JSON;
        returns the path written.  Never raises — a failing crash report
        must not mask the crash it reports (errors land in the return
        value as an empty string)."""
        if path is None:
            path = os.path.join(
                self.dumpDir,
                f"dl4j_tpu_flight_{os.getpid()}_{int(time.time() * 1e3)}"
                ".json")
        try:
            payload = {"reason": reason,
                       "dumped_at": time.time(),
                       "pid": os.getpid(),
                       "records": self.snapshot()}
            with open(path, "w", encoding="utf-8") as f:
                json.dump(payload, f, default=str)
            self.lastDumpPath = path
            return path
        except Exception:
            return ""


_default = FlightRecorder()


def flight_recorder() -> FlightRecorder:
    """The process-global recorder."""
    return _default


def set_flight_recorder(fr: FlightRecorder) -> FlightRecorder:
    """Swap the global recorder (tests); returns the previous one."""
    global _default
    prev, _default = _default, fr
    return prev
