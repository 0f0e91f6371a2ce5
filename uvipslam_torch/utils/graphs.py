"""Captured segments of a device step: the port's counterpart of the
reference's compiled step.

The reference runs a whole frame as one XLA program that the host starts
once (`jax.jit` of the step, `lax.switch`/`lax.cond` inside it). The port
cuts a frame at its host reads into segments, each a function of tensor
trees that makes no host read and takes its code path from Python values
alone. `Segments.run(key, fn, *trees)` runs one:

- `key` is a tuple: the segment's name first, then every Python value
  that picks the code path inside it (a state flag, `need`, `hygiene`).
  No tensor value may choose a path in a segment.
- `trees` are dataclasses, tuples, lists and dicts of tensors. Their
  values at a call are copied into static input buffers laid out as the
  call's tensors are (shape, strides, and the storage offset modulo 512
  bytes; the buffers come from the step's one pool, below), so every
  operation sees the layout the eager step gives it: a
  matrix product of a transposed view rounds otherwise than one of a
  contiguous copy, and a reduction's order follows its input's 16-byte
  alignment. One graph serves one key with one layout of its inputs
  (shapes, strides, dtypes, and for tensors of more than one element the
  offset modulo 16 bytes); another layout is captured anew, as XLA
  compiles a program anew for new shapes. The layouts settle after a
  run's first frames. No torch.Generator may ride in the trees: a
  segment draws nothing (the steps draw their RANSAC uniforms before it).
- On CUDA, the first call of a key and layout copies its inputs in, runs
  `fn` once on a side stream if the key is new (the warm-up torch
  requires: it fills the lazy caches, builds and loads the kernels and
  sets up the side stream's cuBLAS workspace), captures `fn` over the
  static buffers into a `torch.cuda.CUDAGraph` (one memory pool for all
  of a step's graphs, which are replayed one at a time on one stream),
  and replays it. Every later call copies the inputs in and replays.
- On the CPU, a graph is its function called on the static buffers, its
  results written into the static outputs that the first call returned
  (that call's capture is its run): the plain form of a capture, with the
  same copy-in and copy-out. The tests exercise the bookkeeping with it.
- Each call hands back fresh output tensors copied out of the static
  outputs (an output leaf that is one of the static inputs, passed
  through, is the caller's own tensor), so what a step returned never
  changes under a later call.
- A capture or replay that fails raises `SegmentError` naming the key
  (a host read, a host-to-device copy or a cache miss inside a capture
  fails it). Nothing falls back to the eager step.
- The counters in `COUNTERS` (the hand kernels' `ops.klt.patch_launches`,
  `refine_launches`, `refine_wide_calls`, and any that `counted` adds
  for a while) move by what the captured code adds, once per call: each
  graph records their change during its capture and adds it on every
  replay (the warm-up and the capture are not counted). A replay runs no
  Python, so these counts are the capture's times the replays; a
  profiler trace of a replay is what holds them against the kernels the
  device ran. `captures`, `replays` and `capture_seconds` count the rest.
- The step's spans (`utils.spans`; `Segments.spans`, which the step
  shares): each replay runs in a span `step.graph.<segment>`, its host
  work before the replay in `graph.prep`, its copies in and out in
  `graph.copy`, and each capture with its warm-up in `step.graph.capture`
  (the span of `capture_seconds`). The `step.<stage>` spans inside a
  graph open only while it is captured (or its CPU plain form runs), and
  the recorder counts them toward the capture (or the replay). With the
  recorder timing replays, each replay on the card runs between two
  timing events recorded outside the graph.
- `Segments(device, graphs=False)` is the eager form: `run` calls
  `fn(*trees)` and nothing else, so a step composes its frame of the same
  segments either way.

`Segments.scan(key, body, carry, xs, length, consts)` is the counterpart
of the reference's `lax.scan` for the loops that run outside any segment
(the VIO init's, the closing pass's BAs and essential graph): on CUDA the
first step of a key and carry layout captures `body(carry, x_k, *consts)`
as one graph (after the key's warm-up), and every step replays it. The
carry stays in the graph's static buffers: after a replay one device copy
moves its outputs into the inputs of the next step's graph (the same
graph, or the one of the outputs' layout when it differs from the
initial carry's: the plain loop's first step sees the caller's layout,
its later steps the body's), together with step k's slice of `xs`;
nothing is copied out until the loop ends. `scan_steps` counts the
replays, each in a span `step.graph.scan.<name>`. Its rules:

- Nesting: inside a segment (its warm-up, capture or CPU plain form) or
  any stream capture, with `graphs=False`, and so in a fleet's `one`
  step's own `segments`, `scan` runs the plain loop (`plain_scan`, the
  loops' default),
  which the outer capture records as it records any code. Graphs are
  never nested. On the CPU with graphs on, the steps run the plain form
  of a capture, as `run` does.
- Trap 1, the closure: a body may close over Python values only, and
  those belong in its key; every tensor it reads comes through `carry`,
  `xs` or `consts`. The constants are copied into static buffers (shared
  by the key's graphs) at every call, so a graph never reads a tensor of
  an earlier call (which would be freed memory on the card, and a stale
  value in the CPU's plain form, which replays the first call's body). A
  body writes none of its inputs in place.
- Trap 2, the step slice's layout: `xs` is scanned along its first
  dimension. A slice of a step-minor window (`omegas[..., k, :]` of
  [K, T, 3] sits at 12k bytes, its 16-byte alignment cycling through four
  values) would otherwise need one graph per alignment. `scan` instead
  makes one contiguous step-major copy of `xs` per call and copies step
  k's slice into one static slice. A body's first operation on its slice
  must be elementwise (the preintegration subtracts the bias), which
  rounds alike whatever the layout, so the bits stay the plain loop's.

`Segments.lifted_scan` (`scan`'s arguments but `ys`) is the counterpart
of the reference's `vmap(scan(body))`, for a loop inside a stage that a
fleet runs over its streams (`tree.over_streams`, a `torch.func.vmap`),
where no graph can be captured step by step. It is one
`torch.autograd.Function`
(`_LiftedScan`, the idiom of `ops.klt._PatchOp`): outside any vmap its
forward is the plain loop; under the vmap its rule takes the leaves'
stream dimension to the front (a leaf the map does not cover is
repeated), puts `xs` step-major as [T, G, ...] and runs `scan` (key + the
word "streams") of `torch.func.vmap(body)` over the G streams of the
group: one graph per key, group size and carry layout, replayed once per
iteration, and with `graphs=False` the plain loop of the vmapped body. The
trees pass through the Function as flat tensor lists, their skeletons
(no tensor) beside them; the vmapped body is made anew at each call and
reads only Python values. A fleet's `one` step runs its VIO init's loops
through its fleet's `lifted_scan`; on the CPU both forms give the old
form's bits (the plain loops under the fleet's vmap).

The single-stream steps (`VipStep`, `MonoStep`) and the fleet steps
(`VipFleetStep`, `MonoFleetStep`, through `device_tracker.Fleet`) each
own one `Segments`, so one memory pool per step, and one pool of static
input buffers (`buffers`), keyed by the layout `_like` reproduces (shape,
strides, dtype, offset modulo 512 bytes): the i-th input leaf of a layout
in a graph takes the pool's i-th buffer of it, so one graph's buffers are
distinct and every segment graph and every scan's step slice and
constants share them; only a scan's carry, which lives in its graph's
buffers across the loop and which `then` hands from one graph's outputs
to the next one's inputs, keeps buffers of its own. That is safe because
a step replays its graphs one at a time on one stream, every call copies
all of its inputs in before it replays and its new outputs out before
any other graph runs, and an output that is an input comes back as the
caller's own tensor. Keys, layouts and captures are what they were with
one static copy per graph, and so are the bits. A fleet's segment takes
its stream groups as index tensors among its inputs: the key holds only
whether each group is empty, whole or some rows, the layout the index
tensors' lengths, so every group of one size replays one graph whatever
its members (a function that computed its rows from Python stream ids
would bake the capture's rows into the graph). `graphs_per_key` counts
the layouts met per key. `memory()` splits what the graphs hold. The
cost of the design: every static output stays in the graphs' memory
pool, and the pool holds the largest set of input leaves of each layout
that one graph takes, the whole state where a segment reads a few fields
(a fleet of 8 VIP streams at 512x640 over 36 frames on an H100, 73
graphs: a 879 MiB pool where one copy per graph and per scan would hold
5,968 + 1,204 MiB, 111 MiB of scan carries and 2,760 MiB of static
outputs; 4.4 GiB above the run's start at its peak, against 9.1 GiB with
one copy per graph).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

from uvipslam_torch.ops import klt
from uvipslam_torch.utils.spans import Spans, spanned

ALIGN_BYTES = 512          # the CUDA caching allocator's block alignment
# (holder, attribute) of each counter that a replay advances by its capture's change
COUNTERS = [(klt, "patch_launches"), (klt, "refine_launches"), (klt, "refine_wide_calls")]


class SegmentError(RuntimeError):
    """A segment's capture or replay failed."""


def _map(fn, tree, leaf=lambda x: isinstance(x, torch.Tensor)):
    """`tree` with every leaf t (a tensor, or what `leaf` picks) replaced
    by fn(t); dataclasses, tuples, lists and dicts are walked, anything
    else is kept."""
    if leaf(tree):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _map(fn, getattr(tree, f.name), leaf)
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, t, leaf) for t in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v, leaf) for k, v in tree.items()}
    return tree


def _leaves(tree) -> list:
    out = []
    _map(lambda t: out.append(t) or t, tree)
    return out


def _rebuild(tree, leaves):
    it = iter(leaves)
    return _map(lambda _: next(it), tree)


_HOLE = object()         # a tensor's place in a tree's skeleton


def _skeleton(tree):
    """`tree` with its tensors taken out (their places marked), so that
    holding it keeps no tensor alive."""
    return _map(lambda _: _HOLE, tree)


def _fill(skeleton, leaves):
    """The tree of `skeleton` with its marked places filled by `leaves`."""
    it = iter(leaves)
    return _map(lambda _: next(it), skeleton, leaf=lambda x: x is _HOLE)


def _has_generator(tree) -> bool:
    if isinstance(tree, torch.Generator):
        return True
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return any(_has_generator(getattr(tree, f.name)) for f in dataclasses.fields(tree))
    if isinstance(tree, (tuple, list)):
        return any(_has_generator(t) for t in tree)
    if isinstance(tree, dict):
        return any(_has_generator(t) for t in tree.values())
    return False


def _layout(t: torch.Tensor) -> tuple:
    """What of a tensor's layout a graph is specialized to."""
    align = t.storage_offset() * t.element_size() % 16 if t.numel() > 1 else 0
    return t.shape, t.stride(), t.dtype, align


def _span(t: torch.Tensor) -> int:
    """Elements of t's storage from its first element to its last."""
    if t.numel() == 0:
        return 0
    return 1 + sum((n - 1) * s for n, s in zip(t.shape, t.stride()))


def _pool_key(t: torch.Tensor) -> tuple:
    """The layout `_like` reproduces: a static buffer of this key serves
    every tensor of it."""
    return t.shape, t.stride(), t.dtype, t.storage_offset() % max(1, ALIGN_BYTES //
                                                                 t.element_size())


def _bytes(tensors) -> int:
    """Bytes of the distinct storages under `tensors`."""
    seen = {}
    for t in tensors:
        s = t.untyped_storage()
        seen[s.data_ptr()] = s.nbytes()
    return sum(seen.values())


def _like(t: torch.Tensor, device) -> torch.Tensor:
    """An uninitialized tensor on `device` with t's dtype, shape and
    strides, at t's storage offset modulo ALIGN_BYTES."""
    off = t.storage_offset() % max(1, ALIGN_BYTES // t.element_size())
    base = torch.empty(off + _span(t), dtype=t.dtype, device=device)
    return base.as_strided(t.shape, t.stride(), off)


def _region(t: torch.Tensor) -> torch.Tensor:
    """t's storage from its first element to its last, as flat bytes."""
    return t.as_strided((_span(t),), (1,), t.storage_offset()).view(torch.uint8)


def _copy(dsts, srcs):
    """dst <- src for each pair of one layout: byte regions in one foreach
    copy, `copy_` for a source on another device (a host bundle)."""
    fast_d, fast_s = [], []
    for d, s in zip(dsts, srcs):
        if d.numel() == 0:
            continue
        if d.device == s.device:
            fast_d.append(_region(d))
            fast_s.append(_region(s))
        else:
            d.copy_(s)
    if fast_d:
        torch._foreach_copy_(fast_d, fast_s)


@contextlib.contextmanager
def counted(holder, attr: str):
    """Within the block, `holder.<attr>` is one of the COUNTERS: graphs
    captured meanwhile advance it on every replay by what their capture
    added to it."""
    COUNTERS.append((holder, attr))
    try:
        yield
    finally:
        COUNTERS.remove((holder, attr))


def _counters(which) -> tuple:
    return tuple(getattr(h, a) for h, a in which)


def _set_counters(which, values):
    for (h, a), v in zip(which, values):
        setattr(h, a, v)


@dataclasses.dataclass
class _Graph:
    fn: object               # the function (the CPU's plain form replays it)
    static_in: list          # the static input buffers, flattened
    static_trees: tuple      # the same, as the trees fn takes
    out: object              # the static output tree
    source: list             # per output leaf: ("in", j) or ("new", k)
    static_new: list         # distinct static output tensors that are no input
    counters: list           # the COUNTERS at the capture
    delta: tuple             # their change during the capture
    graph: object = None     # torch.cuda.CUDAGraph (None on the CPU)
    then: tuple = None       # a scan step's graph: the spec of the next step's
    private: int = 0         # a scan step's graph: its first `private` inputs, the
    #                          carry, are its own (the rest come from the pool)


class Segments:
    """The graphs of one step, one per key and input layout (see the
    module docstring): `graphs` maps (key, layout) to a graph, `keys` the
    keys met, `buffers` the pool of static input buffers by layout. With
    `graphs=False`, `run` calls the function and `scan` (and
    `lifted_scan`'s lifted loop) runs its plain loop. `spans` (default
    one of its own) is the step's `utils.spans.Spans`."""

    def __init__(self, device, graphs: bool = True, spans: Spans | None = None):
        self.device = torch.device(device)
        self.spans = Spans() if spans is None else spans
        self.enabled = graphs
        self.cuda = self.device.type == "cuda"
        self.graphs: dict = {}
        self.captures = 0
        self.replays = 0
        self.scan_steps = 0
        self.capture_seconds = 0.0
        self._stream = None
        self._pool = None
        self._warm: set = set()         # keys warmed up on the side stream
        self.buffers: dict = {}         # layout -> the pool's static buffers of it
        self._scan_sets: dict = {}      # a scan's (key, layouts) -> its static slice and
        #                                 constants (buffers of the pool)
        self._inside = 0                # > 0 while a segment's or a step's code runs

    @property
    def keys(self) -> set:
        return {k for k, _ in self.graphs}

    def graphs_per_key(self) -> dict:
        """key -> the number of graphs captured for it (one per input
        layout: a count that keeps growing means the layouts drift)."""
        out: dict = {}
        for k, _ in self.graphs:
            out[k] = out.get(k, 0) + 1
        return out

    def memory(self) -> dict:
        """Bytes the graphs hold, by kind: `static_in` the pool of static
        input buffers (segments' inputs and scans' step slices and
        constants), `carries` the scans' private carry buffers,
        `static_out` the static outputs (on the card in the graphs' memory
        pool); `unpooled_in` and `unpooled_scan` what the inputs and the
        scans' constants would hold with one static copy per graph and per
        scan key and layout (no pool)."""
        segs = [g for g in self.graphs.values() if g.then is None]
        scans = [g for g in self.graphs.values() if g.then is not None]
        return dict(
            static_in=_bytes(t for ts in self.buffers.values() for t in ts),
            carries=_bytes(t for g in scans for t in g.static_in[:g.private]),
            static_out=_bytes(t for g in self.graphs.values() for t in g.static_new),
            unpooled_in=sum(_bytes(g.static_in) for g in segs),
            unpooled_scan=sum(_bytes(ts) for ts in self._scan_sets.values()))

    def _static(self, leaves) -> list:
        """Static buffers from the pool for one graph's leaves: the i-th
        leaf of a layout takes the pool's i-th buffer of it (made at its
        first use), so the buffers of one graph are distinct and every
        graph shares them with the others. Safe because a step replays its
        graphs one at a time on one stream, each call copies all of its
        inputs in before its replay and its new outputs out after it, and
        an output that is an input comes back as the caller's tensor."""
        taken: dict = {}
        out = []
        for t in leaves:
            k = _pool_key(t)
            i = taken[k] = taken.get(k, -1) + 1
            bufs = self.buffers.setdefault(k, [])
            if i == len(bufs):
                bufs.append(_like(t, self.device))
            out.append(bufs[i])
        return out

    def run(self, key: tuple, fn, *trees):
        """fn(*trees) through the graph of `key` and the inputs' layout,
        captured at its first call; returns fresh outputs."""
        if not self.enabled:
            return fn(*trees)
        sp = self.spans
        with sp("graph.prep"):
            flat = _leaves(trees)
            spec = (key, tuple(_layout(t) for t in flat))
            g = self.graphs.get(spec)
        captured = g is None
        if captured:
            static_in = self._static(flat)
            _copy(static_in, flat)
            g = self._capture(spec, fn, static_in, _rebuild(trees, static_in))
        try:
            with sp("graph.copy"):
                _copy(g.static_in, flat)
            self._launch(f"step.graph.{key[0]}", g, run_plain=not captured)
            with sp("graph.copy"):
                fresh = [_like(t, self.device) for t in g.static_new]
                _copy(fresh, g.static_new)
                out = _rebuild(g.out, [flat[j] if kind == "in" else fresh[j]
                                       for kind, j in g.source])
        except Exception as e:
            raise SegmentError(f"segment {key!r}: replay failed: {e}") from e
        self.replays += 1
        return out

    def scan(self, key: tuple, body, carry, xs=None, length: int | None = None, consts=(),
             ys: bool = False):
        """`lax.scan(body, carry, xs, length)` with tensor constants: step k
        is carry = body(carry, x_k, *consts), x_k the k-th entry of each
        leaf of `xs` along its first dimension (None without `xs`).
        Returns the final carry; with `ys` the body returns (carry, y)
        and the scan (carry, the y's stacked along a new first dimension).
        Outside any segment, with graphs on, each step replays the graph
        of `key` and the carry's layout (see the module docstring; on the
        CPU its plain form); inside a segment or a capture and with
        `graphs=False` the steps are the plain loop's."""
        if not self.enabled or self._inside or (self.cuda
                                                and torch.cuda.is_current_stream_capturing()):
            return plain_scan(key, body, carry, xs, length, consts, ys)
        n = _n_steps(xs, length)
        if n == 0:
            return plain_scan(key, body, carry, xs, length, consts, ys)
        skey = ("scan",) + tuple(key)
        span, sp = f"step.graph.scan.{key[0]}", self.spans
        with sp("graph.prep"):
            # trap 2: xs step-major and contiguous, copied once, so that
            # every step's slice has one layout, that of the static slice
            xs_c = _map(lambda t: t.contiguous(), xs)
            fixed = (_map(lambda t: t[0], xs_c), consts)
            flat_fixed = _leaves(fixed)
            n_x = len(_leaves(fixed[0]))
            fspec = (skey, tuple(_layout(t) for t in flat_fixed))
            shared = self._scan_sets.get(fspec)
            if shared is None:
                shared = self._scan_sets[fspec] = self._static(flat_fixed)
            src = _leaves(carry)
            spec = (skey, (tuple(_layout(t) for t in src), fspec[1]))
        out_ys = []
        try:
            # trap 1: the constants are copied in at every call
            with sp("graph.copy"):
                _copy(shared, flat_fixed)
            for k in range(n):
                with sp("graph.prep"):
                    dst, srcs = [], []
                    if k > 0:       # step 0's slice came in with the constants
                        dst += shared[:n_x]
                        srcs += _leaves(_map(lambda t, k=k: t[k], xs_c))
                    g = self.graphs.get(spec)
                captured = g is None
                if captured:
                    _copy(dst, srcs)
                    dst, srcs = [], []
                    static_c = [_like(t, self.device) for t in src]
                    _copy(static_c, src)
                    g = self._capture(spec, lambda c, x, k_: body(c, x, *k_),
                                      static_c + shared,
                                      (_rebuild(carry, static_c),) + _rebuild(fixed, shared))
                    g.then = self._scan_then(spec, g, len(src), ys)
                    g.private = len(src)
                with sp("graph.copy"):
                    if not captured:
                        for d, t in zip(g.static_in, src):
                            if d is not t:
                                dst.append(d)
                                srcs.append(t)
                    _copy(dst, srcs)
                self._launch(span, g, run_plain=not captured)
                self.scan_steps += 1
                out = [g.static_in[j] if kind == "in" else g.static_new[j]
                       for kind, j in g.source]
                src, spec = out[:len(src)], g.then
                if ys:
                    with sp("graph.copy"):
                        fresh = [_like(t, self.device) for t in out[len(src):]]
                        _copy(fresh, out[len(src):])
                        out_ys.append(_rebuild(g.out[1], fresh))
            with sp("graph.copy"):
                fresh = [_like(t, self.device) for t in src]
                _copy(fresh, src)
        except SegmentError:
            raise
        except Exception as e:
            raise SegmentError(f"scan {key!r}: replay failed: {e}") from e
        last = _rebuild(g.out[0] if ys else g.out, fresh)
        return (last, _stack(out_ys)) if ys else last

    def lifted_scan(self, key: tuple, body, carry, xs=None, length: int | None = None,
                    consts=()):
        """`scan`'s loop as one operation that `torch.func.vmap` batches
        (the counterpart of the reference's `vmap(scan(body))`): outside
        any vmap it is the plain loop; under `tree.over_streams` its rule
        lifts the loop over the stream axis and runs `scan` (key + the
        word "streams") of the vmapped body on the leaves stacked stream
        first, so a fleet's stage replays one graph per iteration for all
        of its streams, and with `graphs=False` the plain loop of the
        vmapped body. `scan`'s arguments and rules (no `ys`); returns the
        final carry."""
        lift = _Lift(self, tuple(key), body, length, carry, xs, consts)
        out = _LiftedScan.apply(lift, *_leaves((carry, xs, consts)))
        return _fill(lift.carry, out)

    # ------------------------------------------------------------------
    def _scan_then(self, spec, g: _Graph, n_carry: int, ys: bool) -> tuple:
        """The spec of the graph that takes this one's carry on: the layout
        of its carry outputs (the plain loop's next step sees them so)."""
        if ys and not (isinstance(g.out, tuple) and len(g.out) == 2):
            raise SegmentError(f"scan {spec[0][1:]!r}: the body returns no (carry, y) pair")
        out = [g.static_in[j] if kind == "in" else g.static_new[j] for kind, j in g.source]
        n_out = len(_leaves(g.out[0] if ys else g.out))
        if n_out != n_carry:
            raise SegmentError(f"scan {spec[0][1:]!r}: the body returns {n_out} carry leaves "
                               f"for {n_carry}")
        return (spec[0], (tuple(_layout(t) for t in out[:n_carry]), spec[1][1]))

    @spanned("step.graph.capture")
    def _capture(self, spec, fn, static_in, static_trees) -> _Graph:
        """fn captured over the static input buffers `static_in` (the
        leaves of `static_trees`, which fn takes), in a span
        `step.graph.capture`."""
        t0 = time.perf_counter()
        key = spec[0]
        if _has_generator(static_trees):
            raise SegmentError(f"segment {key!r}: a torch.Generator in its inputs (a segment "
                               f"draws nothing)")
        counters = list(COUNTERS)
        before = _counters(counters)
        self._inside += 1
        self.spans.held += 1
        try:
            if self.cuda:
                graph, out, delta = self._cuda_capture(key, fn, static_trees, counters)
            else:
                graph, out = None, fn(*static_trees)
                delta = tuple(a - b for a, b in zip(_counters(counters), before))
        except Exception as e:
            # a failed capture can leave its memory pool marked as being
            # recorded to: later captures take a new pool
            self._pool = None
            raise SegmentError(f"segment {key!r}: capture failed: {e}") from e
        finally:
            self._inside -= 1
            self.spans.held -= 1
            _set_counters(counters, before)
        ids = {id(t): j for j, t in enumerate(static_in)}
        source, static_new, at = [], [], {}
        for t in _leaves(out):
            if id(t) in ids:
                source.append(("in", ids[id(t)]))
            else:
                if id(t) not in at:
                    at[id(t)] = len(static_new)
                    static_new.append(t)
                source.append(("new", at[id(t)]))
        # a captured graph needs its function no more; keeping it would tie
        # the step (which the function's closure holds) to its own graphs in
        # a reference cycle, which only the garbage collector frees
        g = _Graph(fn if graph is None else None, static_in, static_trees, out, source,
                   static_new, counters, delta, graph)
        self.graphs[spec] = g
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0
        return g

    def _cuda_capture(self, key, fn, static_trees, counters):
        """Warm-up (once per key: the lazy caches, the kernels' build and
        the side stream's cuBLAS workspace do not depend on the layout)
        and capture on the side stream, the stream's own capture calls
        rather than torch.cuda.graph's, which empties the allocator's
        cache at every capture."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        side, main = self._stream, torch.cuda.current_stream(self.device)
        side.wait_stream(main)
        try:
            with torch.cuda.stream(side):
                if key not in self._warm:
                    fn(*static_trees)
                    self._warm.add(key)
                mid = _counters(counters)
                torch.cuda.synchronize(self.device)
                graph = torch.cuda.CUDAGraph()
                graph.capture_begin(pool=self._pool)
                try:
                    out = fn(*static_trees)
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass        # the capture is invalid already; the first error tells why
                    raise
                graph.capture_end()
        finally:
            main.wait_stream(side)
        delta = tuple(a - b for a, b in zip(_counters(counters), mid))
        return graph, out, delta

    def _launch(self, span: str, g: _Graph, run_plain: bool = True):
        """One replay of g over its static inputs, in a span `span`, and
        the counters advanced by its capture's change. `run_plain=False`
        right after a CPU capture, whose call left this call's results in
        the static outputs already."""
        with self.spans(span):
            if g.graph is not None:
                self.spans.device(g.graph.replay)
            elif run_plain:
                # what the plain form's call counts is replaced by the
                # capture's change, as a replay counts
                counters = list(dict.fromkeys(COUNTERS + g.counters))
                before = _counters(counters)
                self._inside += 1
                self.spans.held += 1
                try:
                    res = _leaves(g.fn(*g.static_trees))
                finally:
                    self._inside -= 1
                    self.spans.held -= 1
                    _set_counters(counters, before)
                _copy([g.static_new[k] for kind, k in g.source if kind == "new"],
                      [r for (kind, _), r in zip(g.source, res) if kind == "new"])
        _set_counters(g.counters, tuple(a + d for a, d in zip(_counters(g.counters), g.delta)))


class _Lift:
    """One call of `Segments.lifted_scan`: its Python values and the
    skeletons of its trees, whose leaves go through `_LiftedScan.apply`
    flat (carry, xs, constants). It holds no tensor: a captured body
    holds it and must read no tensor of an earlier call."""

    def __init__(self, seg, key, body, length, carry, xs, consts):
        self.seg, self.key, self.body, self.length = seg, key, body, length
        self.carry, self.xs, self.consts = _skeleton(carry), _skeleton(xs), _skeleton(consts)
        self.sizes = tuple(len(_leaves(t)) for t in (carry, xs, consts))

    def trees(self, flat):
        n_c, n_x, _ = self.sizes
        return (_fill(self.carry, flat[:n_c]), _fill(self.xs, flat[n_c:n_c + n_x]),
                _fill(self.consts, flat[n_c + n_x:]))

    def body_of_leaves(self, c, x, k):
        """The body over flat leaves (what the vmapped loop runs): the
        carry's leaves out."""
        carry, x_k, consts = self.trees(list(c) + list(x or ()) + list(k))
        return _leaves(self.body(carry, x_k, *consts))


class _LiftedScan(torch.autograd.Function):
    """A `_Lift`'s loop as one operation: forward is the plain loop, and
    the vmap rule (the idiom of `ops.klt._PatchOp`) moves each leaf's
    stream dimension to the front (repeating a leaf the map does not
    cover), puts `xs` step-major as [T, G, ...] and runs the Segments'
    `scan` of the body vmapped over the streams: one graph per key, group
    size and carry layout, replayed once per iteration. Returns the final
    carry's leaves."""

    @staticmethod
    def forward(lift, *flat):
        carry, xs, consts = lift.trees(flat)
        return tuple(_leaves(plain_scan(lift.key, lift.body, carry, xs, lift.length, consts)))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, lift, *flat):
        n_c, n_x, _ = lift.sizes
        flat = klt._stream_first(info, in_dims[1:], flat)
        c, x, k = flat[:n_c], flat[n_c:n_c + n_x], flat[n_c + n_x:]
        x = [t.movedim(0, 1) for t in x] if n_x else None      # [T, G, ...]
        body = torch.func.vmap(lift.body_of_leaves, in_dims=(0, 0 if n_x else None, 0))
        out = lift.seg.scan(lift.key + ("streams",), body, list(c), x, lift.length, (list(k),))
        return tuple(out), (0,) * len(out)


def _n_steps(xs, length) -> int:
    if xs is None:
        return int(length)
    return _leaves(xs)[0].shape[0]


def _stack(ys: list):
    """Per-step trees stacked leaf by leaf along a new first dimension."""
    flat = [_leaves(y) for y in ys]
    return _rebuild(ys[0], [torch.stack(col) for col in zip(*flat)])


def plain_scan(key, body, carry, xs=None, length: int | None = None, consts=(),
               ys: bool = False):
    """`Segments.scan`'s plain loop, with its arguments (the port's loops
    run it by default; `key` is unused): step k is body(carry, x_k,
    *consts), x_k each leaf of `xs` indexed at k along its first
    dimension."""
    out_ys = []
    for k in range(_n_steps(xs, length)):
        out = body(carry, None if xs is None else _map(lambda t: t[k], xs), *consts)
        carry, y = out if ys else (out, None)
        out_ys.append(y)
    return (carry, _stack(out_ys) if out_ys else None) if ys else carry
