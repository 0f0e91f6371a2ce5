"""The recorder's readers and timeline (`recorder.py`), on fake runs and
records: each reader found by name computes its number from the fields
the recorder adds, and reads nothing without them."""

import importlib.util
import os
import types
from typing import NamedTuple

import pytest

import recorder
from conftest import BENCH


class Rec(NamedTuple):
    name: str
    parent: int
    start_ns: int
    end_ns: int
    device_ns: float | None = None


def reader(name):
    path = os.path.join(BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("r_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def tot(host, self_=None, count=1, device=None):
    t = {"count": count, "host_ns": host, "self_ns": host if self_ is None else self_}
    if device is not None:
        t["device_ns"] = device
    return t


@pytest.mark.parametrize("name", sorted(recorder.RECORDED))
def test_without_the_recorder_nothing_is_read(name):
    assert reader(name)(types.SimpleNamespace()) is None
    assert reader(name)(types.SimpleNamespace(spans_setup=None, spans_dive=None, dive_calls=0,
                                              idle_by_span=None)) is None


def test_dive_readers_per_step_call():
    dive = {"step.call": tot(40e6, 10e6, count=4), "step.read": tot(8e6, count=6),
            "graph.prep": tot(2e6, count=12), "graph.copy": tot(6e6, count=24),
            "step.graph.B": tot(3e6, count=4, device=60e6),
            "step.graph.scan.gba": tot(1e6, count=20, device=20e6)}
    run = types.SimpleNamespace(spans_dive=dive, dive_calls=4)
    assert reader("host_busy_ms_per_frame")(run) == pytest.approx(8.0)
    assert reader("segment_host_ms_per_frame")(run) == pytest.approx(2.0)
    assert reader("graph_device_ms_per_frame")(run) == pytest.approx(20.0)
    del dive["step.graph.B"]["device_ns"], dive["step.graph.scan.gba"]["device_ns"]
    assert reader("graph_device_ms_per_frame")(run) is None      # no replay timed


def test_setup_readers():
    recs = [Rec("step.call", -1, 0, 100), Rec("step.graph.capture", 0, 10, 30),
            Rec("step.call", -1, 200, 900), Rec("step.vio_init", 2, 300, 800),
            Rec("step.graph.scan.gba", 3, 310, 320), Rec("step.graph.capture", 3, 400, 600),
            Rec("step.graph.capture", 2, 850, 860), Rec("step.vio_init", 2, 870, 880)]
    run = types.SimpleNamespace(spans_setup=recs)
    assert reader("setup_capture_s")(run) == pytest.approx((20 + 200 + 10) / 1e9)
    # the first VIO init less the capture inside it (not the one after it)
    assert reader("first_vio_init_s")(run) == pytest.approx(300 / 1e9)
    assert reader("first_vio_init_s")(types.SimpleNamespace(spans_setup=recs[:3])) is None


def test_driver_idle_share_counts_the_drivers_own_spans():
    idle = {"step.call": 30, "graph.prep": 5, "graph.copy": 5, "step.graph.B": 10,
            "step.read": 20, "step.keyframe": 30, "outside": 1000}
    assert reader("driver_idle_share")(types.SimpleNamespace(idle_by_span=idle)) == \
        pytest.approx(50.0)
    assert reader("driver_idle_share")(types.SimpleNamespace(idle_by_span={"outside": 5})) \
        is None


def test_innermost_splits_each_span_by_its_children():
    recs = [Rec("step.call", -1, 0, 100), Rec("graph.prep", 0, 10, 20),
            Rec("step.graph.B", 0, 20, 50), Rec("step.read", 2, 30, 40),
            Rec("step.call", -1, 120, 150)]
    assert recorder.innermost(recs) == [
        (0, 10, "step.call"), (10, 20, "graph.prep"), (20, 30, "step.graph.B"),
        (30, 40, "step.read"), (40, 50, "step.graph.B"), (50, 100, "step.call"),
        (120, 150, "step.call")]


def test_idle_by_span_splits_gaps_on_the_shared_clock():
    recs = [Rec("step.call", -1, 0, 100), Rec("graph.prep", 0, 10, 20),
            Rec("step.graph.B", 0, 20, 50), Rec("step.read", 2, 30, 40),
            Rec("step.call", -1, 120, 150)]
    # busy 0-15 and 35-60 (overlapping ops), 125-160
    device = [(0, 15), (35, 10), (40, 20), (125, 35)]
    idle = recorder.idle_by_span(recs, device)
    # idle 15-35: prep 15-20, B 20-30, read 30-35; 60-120: call 60-100,
    # outside 100-120; 120-125: the second call
    assert idle == {"graph.prep": 5, "step.graph.B": 10, "step.read": 5, "step.call": 45,
                    "outside": 20}


def test_per_call_and_segment_table():
    recs = [Rec("step.call", -1, 0, 100), Rec("graph.prep", 0, 0, 2),
            Rec("graph.copy", 0, 2, 5), Rec("step.graph.A", 0, 5, 10, 40.0),
            Rec("graph.copy", 0, 10, 12), Rec("step.read", 0, 12, 30),
            Rec("step.call", -1, 100, 200), Rec("graph.prep", 6, 100, 101),
            Rec("graph.copy", 6, 101, 103), Rec("step.graph.A", 6, 103, 107, 44.0)]
    assert recorder.per_call(recs) == [[100, 40.0], [100, 44.0]]
    table = recorder.segment_table(recs, 2)
    assert table == {"step.graph.A": dict(replays=1.0, host=(12 + 7) / 2, read=9.0,
                                          device=42.0)}


def test_graph_extents_hold_the_gaps_between_a_replays_kernels():
    class Ev:
        def __init__(self, cid):
            self.cid = cid

        def correlation_id(self):
            return self.cid

    # replay 7: kernels 0-10 and 15-20 (extent 20); a lone kernel (3) of its
    # own launch is no replay
    device = [("k", 0, 10, Ev(7)), ("k", 15, 5, Ev(7)), ("k", 30, 4, Ev(3))]
    assert recorder.graph_extents(device) == 20.0
