"""Named host spans of a device step, and a recorder that times them.

Every step (`VipStep`, `MonoStep`, and a fleet step with its `one` step)
owns one `Spans`, `step.spans`, shared with its `Segments` and a loop
closer's. The step's code opens its spans as `with self.spans(name):`.
The names:

- `step.call`: a whole call of the step (`__call__`);
- `step.<stage>`: a stage run eagerly or, inside a segment, while its
  graph is captured (`step.propagate`, `step.keyframe`, `step.vio_init`,
  ...); `stream.process` and `loop.<part>` in a stream and its closer;
- `step.read`: the blocking part of a host read (the device-to-host copy
  of a batch of flags, which waits for the work queued before it);
- `graph.prep`: a segment's or scan's host work before its replay (the
  input leaves, their layouts, the graph's lookup);
- `graph.copy`: the copies of a segment's or scan's inputs into the
  graph's static buffers and of its fresh outputs out of them;
- `step.graph.<segment>`, `step.graph.scan.<name>`: one graph replay;
- `step.graph.capture`: a graph's capture with its warm-up (the span of
  `Segments.capture_seconds`).

A span does one of three things:

- while a torch.profiler session records, it enters `record_function`,
  so a profile shows every span;
- while the recorder is on (`start`), it keeps one record: its name, its
  parent (the innermost recorded span open around it) and its start and
  end on the profiler's clock (`time.perf_counter_ns()` plus one offset
  to `time.time_ns()`, taken at `start`); a span opened while a segment
  is captured or its plain form runs (`held`) is not recorded and counts
  toward its capture or replay;
- otherwise nothing: one attribute check and the profiler's flag.

With `start(events=True)` each graph replay on the card also records a
pair of timing events on the current stream, before and after the
replay and outside the graph, so no graph changes. Their elapsed time is
read after the step's next host read, or at `stop()`, which waits for
what is still pending; nothing else synchronizes for them.

`stop()` returns the records, as `Record`s in the order the spans
opened; `totals()` sums them per name: count, host ns, self ns (the
duration less its recorded children's) and, where replays were timed,
device ns.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import NamedTuple

import torch
from torch.profiler import record_function

_OFF = contextlib.nullcontext()


class Record(NamedTuple):
    name: str
    parent: int           # index of the enclosing record, -1 at the top
    start_ns: int         # the profiler's clock (Unix epoch ns)
    end_ns: int
    device_ns: float | None   # the replay's time between its events, where timed


class Spans:
    """The spans of one step and their recorder (see the module
    docstring). `start(events)`, `stop()` and `totals()` drive the
    recorder; the step calls the object for a span, `read` for a host
    read and `device` around a graph replay."""

    def __init__(self):
        self.on = False
        self.events = False
        self.held = 0              # > 0 while a capture or a plain form runs
        self._reset()
        self._pool: list = []      # timing events free for reuse

    def _reset(self):
        self._names, self._parents, self._t0, self._t1 = [], [], [], []
        self._device: dict = {}
        self._open: list = []
        self._pending: list = []
        self._offset = 0

    def __call__(self, name: str):
        if self.on and not self.held:
            return _Recorded(self, name)
        if torch.autograd._profiler_enabled():
            return record_function(name)
        return _OFF

    # -- the recorder ----------------------------------------------------
    def start(self, events: bool = False):
        """Records from now on, dropping the last recording; `events`
        times each graph replay on the card."""
        self._reset()
        self._offset = time.time_ns() - time.perf_counter_ns()
        self.on, self.events = True, bool(events) and torch.cuda.is_available()

    def stop(self) -> list:
        """Stops recording and returns the records (a span still open ends
        now)."""
        now = time.perf_counter_ns()
        for i in self._open:
            self._t1[i] = now
        self._open = []
        self.on = self.events = False
        self._settle(wait=True)
        off = self._offset
        return [Record(n, p, a + off, b + off, self._device.get(i))
                for i, (n, p, a, b) in enumerate(zip(self._names, self._parents, self._t0,
                                                     self._t1))]

    def totals(self) -> dict:
        """name -> {"count", "host_ns", "self_ns"} of the last recording,
        with "device_ns" for the names whose replays were timed."""
        dur = [b - a for a, b in zip(self._t0, self._t1)]
        child = [0] * len(dur)
        for i, p in enumerate(self._parents):
            if p >= 0:
                child[p] += dur[i]
        out: dict = {}
        for i, name in enumerate(self._names):
            t = out.setdefault(name, {"count": 0, "host_ns": 0, "self_ns": 0})
            t["count"] += 1
            t["host_ns"] += dur[i]
            t["self_ns"] += dur[i] - child[i]
            if i in self._device:
                t["device_ns"] = t.get("device_ns", 0.0) + self._device[i]
        return out

    # -- what the step calls ----------------------------------------------
    def read(self, t: torch.Tensor) -> list:
        """t.tolist() (a host read, which waits for the device) in a
        `step.read` span; then the replays' timing events it waited for
        are read."""
        with self("step.read"):
            vals = t.tolist()
        if self._pending:
            self._settle(wait=False)
        return vals

    def device(self, replay):
        """replay() between two timing events when replays are timed; the
        innermost recorded span (the replay's) gets their elapsed time."""
        if not (self.events and self._open) or self.held:
            return replay()
        e0, e1 = (self._pool.pop() if self._pool else torch.cuda.Event(enable_timing=True)
                  for _ in range(2))
        e0.record()
        out = replay()
        e1.record()
        self._pending.append((self._open[-1], e0, e1))
        return out

    def _settle(self, wait: bool):
        keep = []
        for i, e0, e1 in self._pending:
            if wait:
                e1.synchronize()
            elif not e1.query():
                keep.append((i, e0, e1))
                continue
            self._device[i] = self._device.get(i, 0.0) + e0.elapsed_time(e1) * 1e6
            self._pool += (e0, e1)
        self._pending = keep


class _Recorded:
    """One recorded span (inside `record_function` under a profiler)."""

    __slots__ = ("rec", "name", "i", "rf")

    def __init__(self, rec: Spans, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        self.rf = record_function(self.name) if torch.autograd._profiler_enabled() else None
        if self.rf is not None:
            self.rf.__enter__()
        self.i = len(rec._names)
        rec._names.append(self.name)
        rec._parents.append(rec._open[-1] if rec._open else -1)
        rec._t1.append(0)
        rec._open.append(self.i)
        rec._t0.append(time.perf_counter_ns())
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        rec = self.rec
        if rec._open and rec._open[-1] == self.i:
            rec._t1[self.i] = t1
            rec._open.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def spanned(name: str):
    """A method decorator: the method runs in its object's span `name`
    (`self.spans(name)`)."""
    def wrap(fn):
        @functools.wraps(fn)
        def method(self, *args, **kwargs):
            with self.spans(name):
                return fn(self, *args, **kwargs)
        return method
    return wrap
