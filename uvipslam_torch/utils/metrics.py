"""Structured metrics stream (JSONL).

Counterpart of `uvipslam_tpu/utils/metrics.py`, a copy (host only): every
event is a typed JSONL record (per-frame tracking records, keyframe and
loop events, stage timings, run-level summaries). Recording never reads
a device tensor: callers pass host values, and rows are buffered and
flushed in batches.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager


class MetricsLogger:
    """Buffered JSONL metrics writer.

    >>> ml = MetricsLogger("run_metrics.jsonl", run_id="bench")
    >>> ml.event("frame", frame=3, state="WORKING", n_inliers=180)
    >>> with ml.timer("local_ba"):
    ...     pass
    >>> ml.counter("keyframes", 1)
    >>> ml.close()
    """

    def __init__(self, path: str | None = None, run_id: str = "",
                 flush_every: int = 256):
        self.path = path
        self.run_id = run_id
        self.flush_every = flush_every
        self._rows: list[dict] = []
        self._counters: dict[str, float] = {}
        self._frame_states: dict[str, int] = {}
        self._t0 = time.time()
        self._fh = open(path, "w") if path else None

    # --- recording -----------------------------------------------------

    def event(self, kind: str, **fields) -> None:
        row = {"t": round(time.time() - self._t0, 6), "kind": kind}
        if self.run_id:
            row["run"] = self.run_id
        row.update(fields)
        if kind == "frame":
            s = row.get("state", "?")
            self._frame_states[s] = self._frame_states.get(s, 0) + 1
        self._rows.append(row)
        if len(self._rows) >= self.flush_every:
            self.flush()

    def frame(self, frame_id: int, status: dict) -> None:
        """Record a tracker per-frame status dict as one row."""
        self.event("frame", frame=int(frame_id),
                   **{k: v for k, v in status.items()
                      if isinstance(v, (bool, int, float, str))})

    def counter(self, name: str, inc: float = 1.0) -> None:
        self._counters[name] = self._counters.get(name, 0.0) + inc

    @contextmanager
    def timer(self, name: str, **fields):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.event("timing", stage=name,
                       dur_s=round(time.perf_counter() - t0, 6), **fields)

    # --- lifecycle -----------------------------------------------------

    def summary(self) -> dict:
        # Frame-state counts accumulate at event() time: summary() must
        # survive the periodic flush() that clears the row buffer.
        return {"counters": dict(self._counters),
                "frame_states": dict(self._frame_states),
                "wall_s": round(time.time() - self._t0, 3)}

    def flush(self) -> None:
        if self._fh is not None:
            for r in self._rows:
                self._fh.write(json.dumps(r) + "\n")
            self._fh.flush()
        self._rows.clear()

    def close(self) -> None:
        if self._counters or self._fh is not None:
            self.event("summary", **self.summary())
        self.flush()
        if self._fh is not None:
            self._fh.close()
            self._fh = None
