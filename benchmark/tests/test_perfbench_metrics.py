"""The metrics' arithmetic: each reader is found by name and computes its
number from a run's figures."""

import importlib.util
import json
import os
import types

import pytest

import roofline
import tail
from conftest import BENCH, ROOT


def reader(name):
    path = os.path.join(BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("m_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_of(**kw):
    base = dict(untraced_ms=[], window_s=1.0, stream_frames=0, setup_s=0.0,
                host_syncs=0, captures=0, step_calls=1, trace=None, traced_calls=0,
                live_share=None, untraced_same_s=None, hand=[], starts=[],
                image_hw=(512, 640), peak_bytes=0, streams=1)
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_every_metric_has_a_reader():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(reader(m["name"])), m["name"]


def test_rate_is_over_the_whole_window_and_a_fleet_frame_counts_per_stream():
    # 10 batched frames of 8 streams over a 4 s window (the dive starts and
    # the time between frames in it)
    r = run_of(untraced_ms=[100.0] * 10, window_s=4.0, stream_frames=80, streams=8)
    assert reader("frames_per_s")(r) == pytest.approx(20.0)


def test_tail_is_over_all_frames():
    ms = [10.0] * 95 + [50.0, 60.0, 70.0, 80.0, 90.0]
    assert tail.p95(ms) == 10.0
    assert tail.p95(ms + [100.0]) == 50.0
    assert tail.p95(list(range(1, 21))) == 19
    r = run_of(untraced_ms=ms + [100.0])
    for name in ("frame_ms_p95", "frame_ms_p95.host"):
        assert reader(name)(r) == 50.0
        assert reader(name)(run_of(untraced_ms=ms)) == 10.0
        assert reader(name)(run_of()) is None


def test_counters_per_step_call():
    r = run_of(host_syncs=30, step_calls=10, captures=2, peak_bytes=3 * 2 ** 20, setup_s=12.5)
    assert reader("host_reads_per_frame")(r) == 3.0
    assert reader("captures_in_window")(r) == 2.0
    assert reader("peak_mib")(r) == 3.0
    assert reader("setup_s")(r) == 12.5


def test_trace_metrics_without_a_trace_read_nothing():
    for name in ("host_launch_calls_per_frame", "device_kernels_per_frame", "device_idle_share",
                 "extract_patches_roofline", "anchor_refine_roofline"):
        assert reader(name)(run_of()) is None


def test_trace_readers_and_roofline_counts():
    from devtrace import Trace

    pull = ("extract_patches_kernel", 10_000.0,
            {"grid": [400, 1, 1], "block": [160, 1, 1], "shared memory": 0})
    ref = ("void anchor_refine_kernel<2, 3>", 20_000.0,
           {"grid": [400, 2, 1], "block": [64, 1, 1], "shared memory": 2916})
    tr = Trace(device=[], kernels=2, launches=4, busy_ns=30_000.0, window_ns=100_000.0,
               gaps=[], top_ops=[])
    # busy 30 us of the same frames' 100 us untraced (their traced window
    # of 150 us is not the denominator)
    r = run_of(trace=tr, traced_calls=2, live_share=0.5, hand=[pull, ref], untraced_same_s=1e-4)
    tr.window_ns = 150_000.0
    assert reader("host_launch_calls_per_frame")(r) == 2.0
    assert reader("device_kernels_per_frame")(r) == 1.0
    assert reader("device_idle_share")(r) == pytest.approx(70.0)
    # the pull: 400 patches of 35 x 35 written, positions and corners
    nbytes = 400 * (4 * 35 * 35 + 16)
    assert reader("extract_patches_roofline")(r) == pytest.approx(
        100 * nbytes / roofline.HBM_BYTES_PER_S / 10e-6)
    # the refinement: 2 x 400 slots of which half live, the mean of 10 and 8
    # iterations
    live = 800 * 0.5
    nb = 800 * 18 + 3 * 4 * 169 * live
    fl = 169 * (6 + 14 * 9 + 12) * live
    t = max(nb / roofline.HBM_BYTES_PER_S, fl / roofline.F32_FLOPS_PER_S)
    assert reader("anchor_refine_roofline")(r) == pytest.approx(100 * t / 20e-6)
    # a block of another size counts the smallest patch; no launch reads
    # nothing
    odd = ("extract_patches_kernel", 5.0, {"grid": [4, 1, 1], "block": [96, 1, 1]})
    assert reader("extract_patches_roofline")(run_of(hand=[odd])) == pytest.approx(
        100 * 4 * (4 * 19 * 19 + 16) / roofline.HBM_BYTES_PER_S / 5e-9)
    assert reader("extract_patches_roofline")(run_of(hand=[ref])) is None


def test_refinement_counts_its_image_and_iterations_by_shared_memory():
    """Two launches of one exported frame: half resolution (patch 27, 10
    iterations: 27^2 x 4 + 5,120 bytes of shared memory), then full (25,
    8), each over the distinct pixels under its live tracks' patches."""
    import numpy as np

    half = ("anchor_refine_kernel", 40_000.0,
            {"grid": [3, 1, 1], "block": [64, 1, 1], "shared memory": 27 * 27 * 4 + 5120})
    full = ("anchor_refine_kernel", 30_000.0,
            {"grid": [3, 1, 1], "block": [32, 1, 1], "shared memory": 25 * 25 * 4 + 1024})
    # two live tracks far apart, one dead; at full resolution on 200 x 300
    xy = np.array([[60.0, 60.0], [200.0, 140.0], [10.0, 10.0]])
    start = (xy, np.array([True, True, False]))
    r = run_of(hand=[half, full], starts=[start], image_hw=(200, 300), live_share=0.9)

    def t_of(psize, iters, n=3, live=2):
        nb = n * 18 + 3 * 4 * 169 * live + 4 * live * psize * psize
        fl = 169 * (6 + 14 * iters + 12) * live
        return max(nb / roofline.HBM_BYTES_PER_S, fl / roofline.F32_FLOPS_PER_S)

    want = 100 * (t_of(27, 10) + t_of(25, 8)) / 70e-6
    assert reader("anchor_refine_roofline")(r) == pytest.approx(want)
    # overlapping patches count their pixels once; a patch at the border is clipped
    assert roofline.window_pixels(np.array([[30.0, 30.0], [31.0, 30.0]]), [True, True],
                                  100, 100, 25) == 26 * 25
    assert roofline.window_pixels(np.array([[1.0, 1.0]]), [True], 100, 100, 25) == 625
    assert roofline.refine_psize(7620) == 25 and roofline.refine_psize(2916) is None
    # launches that do not pair with the frames leave the image out
    unpaired = run_of(hand=[half], starts=[start], image_hw=(200, 300), live_share=0.5)
    live = 3 * 0.5
    nb = 3 * 18 + 3 * 4 * 169 * live
    fl = 169 * (6 + 14 * 10 + 12) * live
    t = max(nb / roofline.HBM_BYTES_PER_S, fl / roofline.F32_FLOPS_PER_S)
    assert reader("anchor_refine_roofline")(unpaired) == pytest.approx(100 * t / 40e-6)
