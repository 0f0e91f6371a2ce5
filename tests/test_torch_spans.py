"""The steps' spans and their recorder (`uvipslam_torch.utils.spans`).

Off, a span records nothing and enters `record_function` only under a
profiler; on, it keeps its name, parent and times on the profiler's
clock. The recorder changes nothing a step computes: the graphed steps'
CPU plain form (`graphs=True`), run with it off and on from the first
frame, gives the same outputs, states, host reads and graphs bit for
bit. About 40 s on one worker, most of it the small steps' runs.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from uvipslam_torch.frontend import device_tracker as tdt
from uvipslam_torch.frontend import device_vip as dv
from uvipslam_torch.frontend import tracker as ttr
from uvipslam_torch.frontend.vip_tracker import VipConfig
from uvipslam_torch.io.synthetic import make_sequence
from uvipslam_torch.models.camera import CameraModel
from uvipslam_torch.parallel.replay import batched_replay, stream_generators
from uvipslam_torch.utils import spans as spans_mod
from uvipslam_torch.utils.graphs import Segments
from uvipslam_torch.utils.spans import Spans
from tests.test_torch_threads import one_torch_thread  # noqa: F401

H, W = 120, 160
KF_CAP, PT_CAP = 16, 1024


def _bits(tree):
    from uvipslam_torch.core.tree import tree_leaves
    return [t.detach().contiguous().reshape(-1).view(torch.uint8).clone()
            for x in tree for t in tree_leaves(x)]


@pytest.fixture
def rf_calls(monkeypatch):
    """The names `record_function` is entered with, by the spans."""
    calls = []
    real = spans_mod.record_function

    def spy(name, *a, **k):
        calls.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(spans_mod, "record_function", spy)
    return calls


def test_off_records_nothing_and_enters_no_record_function(rf_calls):
    sp = Spans()
    with sp("step.call"):
        with sp("step.read"):
            pass
    seg = Segments("cpu", graphs=True, spans=sp)
    x = torch.arange(4.0)
    out = seg.run(("A",), lambda t: t * 2, x)
    out = seg.run(("A",), lambda t: t * 2, x)
    assert torch.equal(out, x * 2) and seg.replays == 2
    assert rf_calls == [] and sp.totals() == {} and sp.stop() == []


def test_under_a_profiler_every_span_enters_record_function(rf_calls):
    from torch.profiler import ProfilerActivity, profile

    sp = Spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with sp("step.call"):
            pass
        sp.start()
        with sp("step.read"):
            pass
        sp.stop()
    assert rf_calls == ["step.call", "step.read"]
    assert list(sp.totals()) == ["step.read"]


def test_self_time_is_the_duration_less_the_childrens():
    sp = Spans()
    sp.start()
    with sp("step.call"):
        time.sleep(0.002)
        with sp("graph.prep"):
            time.sleep(0.001)
        with sp("step.graph.B"):
            with sp("step.read"):
                time.sleep(0.001)
    with sp("step.call"):
        pass
    recs = sp.stop()
    tot = sp.totals()
    assert [r.name for r in recs] == ["step.call", "graph.prep", "step.graph.B", "step.read",
                                      "step.call"]
    assert [r.parent for r in recs] == [-1, 0, 0, 2, -1]
    dur = [r.end_ns - r.start_ns for r in recs]
    assert tot["step.call"]["count"] == 2 and tot["step.call"]["host_ns"] == dur[0] + dur[4]
    assert tot["step.call"]["self_ns"] == dur[0] - dur[1] - dur[2] + dur[4]
    assert tot["step.graph.B"]["self_ns"] == dur[2] - dur[3]
    assert tot["step.read"]["self_ns"] == tot["step.read"]["host_ns"] == dur[3]
    assert dur[0] >= 4e6 and all("device_ns" not in t for t in tot.values())
    # a span opened while held (a capture) is not recorded
    sp.start()
    sp.held += 1
    with sp("step.keyframe"):
        pass
    sp.held -= 1
    assert sp.stop() == []


def test_records_are_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile

    sp = Spans()
    sp.start()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            with sp("step.clock"):
                time.sleep(0.001)
    recs = sp.stop()
    events = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                    if e.name() == "step.clock")
    assert len(events) == len(recs) == 5
    for e, r in zip(events, recs):
        assert abs(r.start_ns - e) < 0.25e6, (r.start_ns, e)


def test_device_passes_the_replay_through_without_events():
    sp = Spans()
    sp.start(events=True)               # no card here: no events
    with sp("step.graph.A"):
        assert sp.device(lambda: 7) == 7
    assert sp.events is False and sp.stop()[0].device_ns is None


# -- the steps, recorder off and on ------------------------------------------
def _mono_world():
    seq = make_sequence(n_frames=8, H=H, W=W, n_points=800, seed=3, speed=1.2)
    cam = CameraModel.create(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], width=W,
                             height=H)
    cfg = ttr.TrackerConfig(n_tracks=96, min_init_tracks=60, local_window=8)
    return seq, cam, cfg


def _run_mono(record):
    seq, cam, cfg = _mono_world()
    st, step = tdt.build_tracker(cam, cfg, KF_CAP, PT_CAP, device="cpu", graphs=True)
    if record:
        step.spans.start()
    outs = []
    for img in seq.images:
        st, out = step(st, torch.from_numpy(img.astype(np.float32)))
        outs.append(out)
    return step, (st, outs)


def _run_vip(record):
    cfg = VipConfig(n_tracks=96, min_init_tracks=60, local_window=6, gyr_noise_sd=0.01,
                    acc_noise_sd=0.1, depth_noise_sd=0.05, vio_init_min_kfs=5,
                    vio_init_min_time=1.0)
    seq = make_sequence(n_frames=10, H=H, W=W, n_points=800, seed=3, speed=1.2,
                        gyr_noise=0.005, acc_noise=0.05, gyr_bias=(0.004, -0.006, 0.003),
                        depth_noise=0.02, z_amp=0.5)
    cam = CameraModel.create(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], width=W,
                             height=H)
    st, step = dv.build_vip_tracker(cam, cfg, KF_CAP, PT_CAP, device="cpu", seed=3,
                                    graphs=True)
    if record:
        step.spans.start()
    outs = []
    for b in dv.make_bundles(seq, device="cpu"):
        st, out = step(st, b)
        outs.append(out)
    return step, (dataclasses.replace(st, gen=None), outs)


def _run_mono_fleet(record):
    seqs = [make_sequence(n_frames=6, H=H, W=W, n_points=800, seed=s, speed=1.2)
            for s in (3, 4)]
    _, cam, cfg = _mono_world()
    make_states, _ = batched_replay(cam, cfg, KF_CAP, PT_CAP, device="cpu", seed=5)
    step = tdt.MonoFleetStep(cam, cfg, device="cpu", graphs=True)
    if record:
        step.spans.start()
    imgs = torch.from_numpy(np.stack([s.images for s in seqs]).astype(np.float32))
    st, gens, outs = make_states(2), stream_generators(2, 5, "cpu"), []
    for f in range(imgs.shape[1]):
        st, out = step(st, imgs[:, f], gens)
        outs.append(out)
    return step, (st, outs)


RUNS = {"mono": _run_mono, "vip": _run_vip, "mono_fleet": _run_mono_fleet}


@pytest.fixture(scope="module")
def runs():
    """Each step's run with the recorder off and on (from its first
    frame: captures included); the recording stopped after the run."""
    out = {}
    for name, fn in RUNS.items():
        off_step, off = fn(False)
        on_step, on = fn(True)
        out[name] = dict(off=(off_step, _bits(off)), on=(on_step, _bits(on)),
                         records=on_step.spans.stop(), totals=on_step.spans.totals(),
                         frames=len(on[1]))
    return out


@pytest.mark.parametrize("name", sorted(RUNS))
def test_recorder_changes_nothing_the_step_computes(runs, name):
    (off_step, off), (on_step, on) = runs[name]["off"], runs[name]["on"]
    assert len(off) == len(on) and all(torch.equal(a, b) for a, b in zip(off, on))
    assert off_step.host_syncs == on_step.host_syncs
    assert off_step.segments.graphs_per_key() == on_step.segments.graphs_per_key()
    assert off_step.segments.captures == on_step.segments.captures > 0
    assert off_step.segments.replays == on_step.segments.replays


@pytest.mark.parametrize("name", sorted(RUNS))
def test_recorded_spans_cover_the_calls(runs, name):
    """One `step.call` per frame at the top, every read inside one; the
    segments' prep, copies and replays recorded; the stages inside a
    graph counted toward its capture or replay, never on their own."""
    r = runs[name]
    tot, recs = r["totals"], r["records"]
    step = r["on"][0]
    assert [x.name for x in recs if x.parent < 0] == ["step.call"] * r["frames"]
    assert tot["step.read"]["count"] == step.host_syncs
    assert tot["graph.prep"]["count"] >= step.segments.replays
    assert tot["graph.copy"]["count"] >= 2 * step.segments.replays
    replays = sum(t["count"] for n, t in tot.items() if n.startswith("step.graph.")
                  and n != "step.graph.capture")
    assert replays == step.segments.replays + step.segments.scan_steps
    for x in recs:
        if x.parent >= 0 and recs[x.parent].name.startswith("step.graph."):
            assert x.name == "step.read", x       # nothing but a read in a replay
        assert x.start_ns <= x.end_ns


@pytest.mark.parametrize("name", sorted(RUNS))
def test_capture_span_matches_capture_seconds(runs, name):
    r = runs[name]
    step = r["on"][0]
    cap = r["totals"]["step.graph.capture"]
    assert cap["count"] == step.segments.captures
    assert abs(cap["host_ns"] / 1e9 - step.segments.capture_seconds) < 1e-3


def test_a_fleets_one_step_records_into_the_fleets_recorder(runs):
    fleet = runs["mono_fleet"]["on"][0]
    assert fleet.one.spans is fleet.spans is fleet.segments.spans
    assert fleet.one.segments.spans is fleet.spans
    # the per-stream bootstrap runs the `one` step's stages
    assert "step.two_view_init" in runs["mono_fleet"]["totals"]


def test_scan_replays_record_their_steps():
    """A scan with the recorder on: one replay span per step, the same
    carry as with it off."""
    def body(c, x, k):
        return c * k + x

    xs = torch.arange(12.0).reshape(6, 2)
    outs = []
    for record in (False, True):
        seg = Segments("cpu", graphs=True)
        if record:
            seg.spans.start()
        outs.append(seg.scan(("lin",), body, torch.ones(2), xs, consts=(torch.tensor(0.5),)))
    tot = seg.spans.totals()
    assert torch.equal(outs[0], outs[1])
    assert tot["step.graph.scan.lin"]["count"] == seg.scan_steps == 6
    assert tot["step.graph.capture"]["count"] == seg.captures >= 1
