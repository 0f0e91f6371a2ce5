"""The segment-graph helper (`uvipslam_torch.utils.graphs.Segments`) in its
plain CPU form, and the graphed device steps' bookkeeping on the CPU.

On the CPU a "graph" is its function called on the key's static input
buffers, its results written into the static outputs of the first call
and copied out: the same copy-in, copy-out, counter and key bookkeeping
that the card's captured CUDA graphs go through (tests/test_torch_cuda.py
holds the captures themselves on the card). The steps' graphed runs over
the parity sequences are held bit for bit against their eager runs in
tests/test_torch_vip.py and tests/test_torch_step.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from uvipslam_torch.frontend import device_tracker as tdt
from uvipslam_torch.frontend import tracker as ttr
from uvipslam_torch.io.synthetic import make_sequence
from uvipslam_torch.models.camera import CameraModel
from uvipslam_torch.ops import klt
from uvipslam_torch.ops.klt import build_flow_pyramid
from uvipslam_torch.utils.graphs import SegmentError, Segments, plain_scan
from tests.test_torch_threads import one_torch_thread  # noqa: F401

N_FRAMES = 8


@dataclasses.dataclass
class _Pair:
    a: torch.Tensor
    b: torch.Tensor


def _bits(t):
    return t.detach().contiguous().reshape(-1).view(torch.uint8).clone()


@pytest.fixture(scope="module")
def mono():
    """A graphed and an eager mono step over 8 frames at 120x160 (WORKING
    from frame 1 on, a keyframe on frame 5): per-frame outputs and states,
    and a byte copy of each taken as the step returned it."""
    seq = make_sequence(n_frames=N_FRAMES, H=120, W=160, n_points=800, seed=3, speed=1.2)
    cam = CameraModel.create(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], width=160,
                             height=120)
    cfg = ttr.TrackerConfig(n_tracks=100, min_init_tracks=60, local_window=8)
    imgs = [torch.from_numpy(im.astype(np.float32)) for im in seq.images]
    runs = {}
    for graphs in (False, True):
        st, step = tdt.build_tracker(cam, cfg, 16, 1024, device="cpu", graphs=graphs)
        outs, states, copies = [], [], []
        for img in imgs:
            st, out = step(st, img)
            outs.append(out)
            states.append(st)
            copies.append([_bits(t) for t in _tensors((st, out))])
        runs[graphs] = dict(step=step, outs=outs, states=states, copies=copies)
    return dict(imgs=imgs, cam=cam, cfg=cfg, eager=runs[False], graphed=runs[True])


def _tensors(tree):
    from uvipslam_torch.core.tree import tree_leaves
    return [t for x in tree for t in tree_leaves(x)]


def test_returned_outputs_and_states_never_change(mono):
    """What a graphed step returned keeps its bits under every later frame
    (fresh outputs, copied out of the static ones); the runs equal the
    eager step's."""
    g = mono["graphed"]
    for f in range(N_FRAMES):
        now = [_bits(t) for t in _tensors((g["states"][f], g["outs"][f]))]
        assert all(torch.equal(a, b) for a, b in zip(now, g["copies"][f])), f
        assert all(torch.equal(a, b) for a, b in zip(now, mono["eager"]["copies"][f])), f
    labels = [int(o.state) for o in g["outs"]]
    assert labels[1:] == [ttr.WORKING] * (N_FRAMES - 1), labels
    assert any(int(o.new_kf) >= 0 for o in g["outs"][2:])     # a graphed keyframe


def test_pyramid_handed_over_between_frames(mono):
    """Frame t's pyramid, an output of segment A, reaches frame t + 1's
    propagation as `pyr_prev`: each state's `pyr_prev` is its own frame's
    pyramid, in memory of its own (not segment A's static outputs, which
    the next frame overwrites)."""
    g = mono["graphed"]
    static = {t.untyped_storage().data_ptr() for gr in g["step"].segments.graphs.values()
              for t in gr.static_new + gr.static_in}
    for f, st in enumerate(g["states"]):
        want = build_flow_pyramid(mono["imgs"][f], mono["cfg"].n_levels_klt)
        assert all(torch.equal(a, b) for a, b in zip(st.pyr_prev, want)), f
        assert not {t.untyped_storage().data_ptr() for t in st.pyr_prev} & static, f


def test_key_picks_the_segment():
    """One graph per key: a key met before replays its captured function,
    whatever function the call passes; another key captures anew."""
    seg = Segments("cpu")
    x = torch.arange(4.0)
    assert torch.equal(seg.run(("s", 1), lambda t: t + 1.0, x), x + 1.0)
    assert torch.equal(seg.run(("s", 2), lambda t: t * 3.0, x), x * 3.0)
    assert torch.equal(seg.run(("s", 1), lambda t: t * 3.0, x + 1.0), x + 2.0)
    assert seg.keys == {("s", 1), ("s", 2)}
    assert seg.captures == 2 and seg.replays == 3


def test_new_input_layout_captures_anew():
    """A graph is specialized to its inputs' layout as well: a transposed
    view (a matrix product of it rounds otherwise than one of a
    contiguous copy) or another 16-byte alignment is captured anew under
    the same key, and its static buffers take that layout."""
    seg = Segments("cpu")
    a = torch.arange(9.0).reshape(3, 3)
    buf = torch.arange(20.0)

    def fn(m, v):
        return m @ m, v * 2.0

    for m, v in ((a, buf[0:4]), (a.T, buf[0:4]), (a.T.contiguous(), buf[4:8]),
                 (a, buf[1:5]), (a, buf[8:12])):
        mm, vv = seg.run(("mm",), fn, m, v)
        assert torch.equal(mm, m @ m) and torch.equal(vv, v * 2.0)
    assert seg.keys == {("mm",)} and seg.captures == 3 and seg.replays == 5
    assert seg.graphs_per_key() == {("mm",): 3}
    strides = sorted(g.static_in[0].stride() for g in seg.graphs.values())
    assert strides == [(1, 3), (3, 1), (3, 1)]


def test_rows_as_data_serve_every_group_of_a_size():
    """A stream group passed as an index tensor among the inputs (as the
    fleets pass theirs): groups of one size replay one graph, each call
    gathering its own rows; an index of another length is another
    layout, so another graph under the same key."""
    seg = Segments("cpu")
    x = torch.arange(12.0).reshape(4, 3)

    def fn(t, ix):
        return t.index_select(0, ix["g"]) * 2.0

    for rows in ([0, 3], [2, 1], [1], [3], [0, 2]):
        ix = torch.tensor(rows)
        assert torch.equal(seg.run(("take",), fn, x, {"g": ix}), x[ix] * 2.0)
    assert seg.graphs_per_key() == {("take",): 2} and seg.replays == 5


def test_counter_deltas_added_once_per_call():
    """A graph records the hand-kernel counters' change during its capture
    and adds it on each replay: the counters read what eager calls read,
    the capture not counted on top."""
    seg = Segments("cpu")

    def fn(t):
        klt.patch_launches += 2
        klt.refine_launches += 1
        return t * 2.0

    before = (klt.patch_launches, klt.refine_launches, klt.refine_wide_calls)
    for n in range(1, 4):
        seg.run(("count",), fn, torch.ones(3))
        assert (klt.patch_launches - before[0], klt.refine_launches - before[1],
                klt.refine_wide_calls - before[2]) == (2 * n, n, 0)
    assert [g.delta for g in seg.graphs.values()] == [(2, 1, 0)]
    assert seg.captures == 1 and seg.replays == 3


def test_counted_holder_advanced_by_replays():
    """A counter registered with `counted` is one of the counters a graph
    captured meanwhile advances on each replay by its capture's change;
    a replay calls no Python, so without this a graphed frame would count
    nothing of what its captured code counts."""
    from uvipslam_torch.utils import graphs

    class Calls:
        n = 0

    calls = Calls()
    seg = Segments("cpu")

    def fn(t):
        calls.n += 3
        return t + 1.0

    with graphs.counted(calls, "n"):
        for k in range(1, 4):
            seg.run(("c",), fn, torch.ones(2))
            assert calls.n == 3 * k
    assert (calls, "n") not in graphs.COUNTERS
    seg.run(("c",), fn, torch.ones(2))     # captured while registered: still advanced
    assert calls.n == 12 and seg.captures == 1


def test_eager_form_calls_the_function():
    """`Segments(device, graphs=False)`, the eager steps' form: `run` is
    `fn(*trees)`, with no copy, no graph and no count."""
    seg = Segments("cpu", graphs=False)
    x = torch.arange(3.0)
    out = seg.run(("e",), lambda t: (t, t * 2.0), x)
    assert out[0] is x and torch.equal(out[1], x * 2.0)
    assert not seg.graphs and seg.captures == 0 and seg.replays == 0


def test_inputs_copied_in_and_passed_through():
    """A call's inputs are copied into the key's static buffers (laid out
    as the call's: the storage offset of a view kept modulo the
    alignment), the caller's tensors untouched; an output leaf that is an
    input comes back as the caller's own tensor; outputs that are one
    tensor come back as one fresh tensor."""
    seg = Segments("cpu")
    base = torch.arange(30.0)

    def fn(p):
        s = p.a + p.b
        return _Pair(a=p.a, b=s), s

    p0 = _Pair(a=base[9:12], b=torch.ones(3))
    out, s = seg.run(("pair",), fn, p0)
    static_a = next(iter(seg.graphs.values())).static_in[0]
    assert static_a.storage_offset() == 9 and static_a.data_ptr() != base[9:12].data_ptr()
    assert out.a is p0.a and out.b is s and torch.equal(s, base[9:12] + 1.0)
    p1 = _Pair(a=base[12:15], b=torch.full((3,), 2.0))
    out1, s1 = seg.run(("pair",), fn, p1)
    assert out1.a is p1.a and torch.equal(s1, base[12:15] + 2.0)
    assert torch.equal(s, base[9:12] + 1.0) and torch.equal(base, torch.arange(30.0))


def test_failing_segment_raises_naming_its_key():
    """A segment whose function fails raises SegmentError naming its key
    and keeps no graph; a generator among the inputs is refused (a
    segment draws nothing)."""
    seg = Segments("cpu")

    def bad(t):
        raise ValueError("no host reads here")

    with pytest.raises(SegmentError, match=r"\('bad', True\).*no host reads here"):
        seg.run(("bad", True), bad, torch.ones(2))
    assert not seg.graphs and seg.captures == 0

    @dataclasses.dataclass
    class WithGen:
        x: torch.Tensor
        gen: torch.Generator

    with pytest.raises(SegmentError, match="Generator"):
        seg.run(("gen",), lambda w: w.x, WithGen(torch.ones(2), torch.Generator()))


def test_graphed_step_raises_on_a_failing_stage(mono, monkeypatch):
    """`graphs=True` with a WORKING stage that fails: the step raises
    SegmentError naming the segment's key; nothing carries on eagerly."""
    st, step = tdt.build_tracker(mono["cam"], mono["cfg"], 16, 1024, device="cpu", graphs=True)

    def failing(st):
        raise RuntimeError("stage failed")

    monkeypatch.setattr(step, "_working_solve", failing)
    with pytest.raises(SegmentError, match=r"\('B',\).*stage failed"):
        for img in mono["imgs"]:
            st, _ = step(st, img)
    assert ("B",) not in step.segments.keys
    assert step.segments.keys == {("A",)}


def test_graphs_default_follows_the_device(mono):
    """`graphs=None` means graphs on a CUDA device and the eager step on
    the CPU; the fleet steps stay eager."""
    from uvipslam_torch.frontend import device_vip as tdv
    from uvipslam_torch.frontend import vip_tracker as tvt

    cam, cfg = mono["cam"], mono["cfg"]
    assert not tdt.MonoStep(cam, cfg, device="cpu").graphs
    assert not tdt.MonoStep(cam, cfg, device="cpu").segments.enabled
    assert tdt.MonoStep(cam, cfg, device="cpu", graphs=True).segments.enabled
    assert not tdv.VipStep(cam, tvt.VipConfig(n_tracks=100), 16, device="cpu").graphs
    assert not tdt.MonoFleetStep(cam, cfg, device="cpu").one.graphs


def test_pool_serves_two_segments_of_one_layout_called_interleaved():
    """One static-input pool per Segments: two segments whose inputs have
    one layout take the same buffers, and called in turn on changing
    inputs each still equals its eager call (every call copies its inputs
    in before its replay)."""
    seg = Segments("cpu")
    fa, fb = (lambda t: t * 2.0 + 1.0), (lambda t: t.flip(0) - 3.0)
    for k in range(3):
        x, y = torch.arange(4.0) + k, torch.arange(4.0) * (k + 2)
        assert torch.equal(seg.run(("a",), fa, x), fa(x))
        assert torch.equal(seg.run(("b",), fb, y), fb(y))
    ga, gb = (next(g for (key, _), g in seg.graphs.items() if key == (n,)) for n in "ab")
    assert ga.static_in[0] is gb.static_in[0]
    assert seg.captures == 2 and seg.replays == 6


def test_pool_gives_two_leaves_of_one_layout_two_buffers():
    """Within one graph the i-th leaf of a layout takes the pool's i-th
    buffer of it, so two inputs of one layout stay distinct."""
    seg = Segments("cpu")
    x, y = torch.arange(3.0), torch.full((3,), 5.0)
    for k in range(2):
        assert torch.equal(seg.run(("sub",), lambda a, b: a - b, x + k, y), x + k - y)
    g = next(iter(seg.graphs.values()))
    assert g.static_in[0] is not g.static_in[1]
    assert len(seg.buffers) == 1 and len(next(iter(seg.buffers.values()))) == 2


def test_pooled_bytes_are_the_largest_set_not_their_sum():
    """Two segments holding three and two inputs of one layout pool three
    buffers: the largest set, where one static copy per graph held five."""
    seg = Segments("cpu")
    ts = [torch.full((64,), float(i)) for i in range(3)]
    assert torch.equal(seg.run(("three",), lambda a, b, c: a + b + c, *ts), ts[0] + ts[1] + ts[2])
    assert torch.equal(seg.run(("two",), lambda a, b: a * b, *ts[:2]), ts[0] * ts[1])
    mem = seg.memory()
    assert mem["static_in"] == 3 * 64 * 4 and mem["unpooled_in"] == 5 * 64 * 4
    assert mem["carries"] == 0 and mem["static_out"] == 2 * 64 * 4


def test_a_scans_carry_is_never_pooled():
    """A scan's carry lives across its steps in its graph's own buffers;
    its constants (and a segment's inputs of the same layout) come from
    the pool. A segment called between two scans leaves the second scan's
    result the plain loop's."""
    seg = Segments("cpu")
    c0, k = torch.ones(8), torch.full((8,), 0.5)
    body = lambda c, _, a: c * a + 1.0          # noqa: E731
    want = plain_scan(None, body, c0, length=3, consts=(k,))
    assert torch.equal(seg.scan(("s",), body, c0, length=3, consts=(k,)), want)
    assert torch.equal(seg.run(("seg",), lambda a: a * 4.0, torch.full((8,), 7.0)),
                       torch.full((8,), 28.0))
    assert torch.equal(seg.scan(("s",), body, c0, length=3, consts=(k,)), want)
    pooled = {id(t) for ts in seg.buffers.values() for t in ts}
    scans = [g for g in seg.graphs.values() if g.then is not None]
    assert scans and all(g.private == 1 and id(g.static_in[0]) not in pooled
                         and id(g.static_in[1]) in pooled for g in scans)
    assert seg.memory()["carries"] == sum(g.static_in[0].untyped_storage().nbytes()
                                          for g in scans)
