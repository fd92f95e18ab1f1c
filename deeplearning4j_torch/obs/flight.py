"""Black-box flight recorder — the port's copy of
``deeplearning4j_tpu/obs/flight.py``: a bounded ring of the last N
:class:`RequestRecord` dicts plus health/breaker/watchdog/fault transitions,
dumped atomically to a JSON artifact when something goes wrong.

Stdlib only. The recorder is passive bookkeeping:
components append to it (cheap deque appends under a small lock) and the
*triggers* — health entering ``failed``, a watchdog restart, a circuit
breaker opening — call :meth:`FlightRecorder.dump`, which snapshots both
rings and writes them tmp-then-rename so a crash mid-dump never leaves a
torn artifact. Chaos faults land as instant events in the same ring, so a
dump reads as "what the last few hundred requests saw, and every transition
around the incident".

Like ``chaos/``, the recorder is process-global via :data:`ACTIVE` with an
``install``/``uninstall`` pair: call sites guard with
``if _flight.ACTIVE is not None`` so a serving stack with no recorder pays
one attribute load per site and allocates nothing.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

ACTIVE: Optional["FlightRecorder"] = None


class FlightRecorder:
    """Bounded in-memory ring of request records + transition events.

    ``capacity``/``event_capacity`` bound host memory (deque maxlen — old
    entries fall off, nothing blocks). ``out_dir=None`` keeps the recorder
    live-only: :meth:`dump` records the trigger but writes no file.
    ``max_dumps`` bounds disk: past it, dump files are reused round-robin so
    a flapping breaker cannot fill the artifact volume.
    """

    def __init__(self, capacity: int = 256, event_capacity: int = 512,
                 out_dir: Optional[str] = None, max_dumps: int = 8):
        self.capacity = capacity
        self.out_dir = out_dir
        self.max_dumps = max_dumps
        self._requests: deque = deque(maxlen=capacity)
        self._events: deque = deque(maxlen=event_capacity)
        self._dumps: List[str] = []
        self._dump_seq = 0
        self._lock = threading.Lock()

    # --- recording (cheap, called from hot-adjacent paths) ---
    def record_request(self, record: dict) -> None:
        """Append one completed request's ``RequestRecord`` dict."""
        with self._lock:
            self._requests.append(record)

    def record_event(self, kind: str, name: str, detail: str = "",
                     **data) -> None:
        """Append one transition event (health/breaker/watchdog/fault)."""
        ev = {"t_unix": time.time(), "kind": kind, "name": name,
              "thread": threading.current_thread().name}
        if detail:
            ev["detail"] = detail
        if data:
            ev["data"] = data
        with self._lock:
            self._events.append(ev)

    # --- inspection / dumping ---
    def requests(self) -> List[dict]:
        with self._lock:
            return list(self._requests)

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def snapshot(self) -> dict:
        with self._lock:
            return {"requests": list(self._requests),
                    "events": list(self._events),
                    "dumps": list(self._dumps)}

    @property
    def dumps(self) -> List[str]:
        with self._lock:
            return list(self._dumps)

    def dump(self, reason: str) -> Optional[str]:
        """Write the current rings to ``out_dir`` atomically; returns the
        path (``None`` when the recorder is live-only). Always records the
        trigger itself as an event, so even a live-only recorder shows *why*
        a dump would have fired."""
        self.record_event("dump", reason)
        with self._lock:
            if self.out_dir is None:
                return None
            slot = self._dump_seq % self.max_dumps
            self._dump_seq += 1
            body = {"reason": reason, "t_unix": time.time(),
                    "seq": self._dump_seq,
                    "requests": list(self._requests),
                    "events": list(self._events)}
            path = os.path.join(self.out_dir, f"flight_{slot:02d}.json")
            tmp = path + ".tmp"
            os.makedirs(self.out_dir, exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(body, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            if path not in self._dumps:
                self._dumps.append(path)
            return path


def install(recorder: FlightRecorder) -> FlightRecorder:
    """Make ``recorder`` the process-global flight recorder."""
    global ACTIVE
    ACTIVE = recorder
    return recorder


def uninstall() -> Optional[FlightRecorder]:
    global ACTIVE
    recorder, ACTIVE = ACTIVE, None
    return recorder
