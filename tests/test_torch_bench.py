"""`bench_torch.py`, the port's counterpart of `bench.py`, on the CPU.

- its sequences, cameras, configurations and caps are bench.py's,
  keyword for keyword (bench.py is parsed with `ast`, not imported);
- its gates are bench.py's, on fixed arrays at and beyond each bound;
- its plausibility statistic refuses a clock that does not grow with the
  frames and accepts a linear one;
- a run at 96x128 with `--device cpu`, as its own process, prints both
  lines with every key, its runs bitwise equal and its rate the frames
  over the median run clock (about 15 s);
- without a card and without `--device cpu` it exits non-zero and prints
  no line.
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import bench_torch
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from uvipslam_torch.frontend.tracker import INITIALIZING, WORKING

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bench_calls():
    """{function: {callee: literal keywords}} of bench.py's main_vip and
    main, and the frame counts they set."""
    with open(os.path.join(REPO, "bench.py")) as fh:
        tree = ast.parse(fh.read())
    out = {}
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef) or fn.name not in ("main_vip", "main"):
            continue
        calls = {}
        for n in ast.walk(fn):
            if isinstance(n, ast.Call):
                f = n.func
                name = f.id if isinstance(f, ast.Name) else (
                    f"{f.value.id}.{f.attr}" if isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Name) else None)
                kws = {}
                for k in n.keywords:
                    try:
                        kws[k.arg] = ast.literal_eval(k.value)
                    except ValueError:
                        kws[k.arg] = None
                calls.setdefault(name, kws)
            if isinstance(n, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "N_FRAMES" for t in n.targets):
                v = n.value
                calls["N_FRAMES"] = (ast.literal_eval(v) if isinstance(v, ast.Constant)
                                     else int(ast.literal_eval(v.args[0].args[1])))
        out[fn.name] = calls
    return out


def test_configuration_is_bench_py_s():
    calls = _bench_calls()
    vip, mono = calls["main_vip"], calls["main"]
    b = bench_torch
    assert vip["make_sequence"] == {"n_frames": None, **b.VIP_SEQUENCE}
    assert mono["make_sequence"] == {"n_frames": None, **b.MONO_SEQUENCE}
    for c, seq in ((vip, b.VIP_SEQUENCE), (mono, b.MONO_SEQUENCE)):
        assert c["CameraModel.create"] == {"width": seq["W"], "height": seq["H"]}
    assert vip["VipConfig"] == b.VIP_CONFIG
    assert mono["TrackerConfig"] == b.MONO_CONFIG
    assert vip["build_vip_tracker"] == b.CAPS == mono["build_tracker"]
    assert (vip["N_FRAMES"], mono["N_FRAMES"]) == (b.VIP_FRAMES, b.MONO_FRAMES)


def _path(n, span=4.0):
    """A ground-truth path [n, 3] with a full-rank spread and its span."""
    s = np.linspace(0.0, 1.0, n)
    P = np.stack([span * s, 0.6 * np.sin(5 * s), 0.3 * np.cos(7 * s)], 1)
    return P, float(np.linalg.norm(P[-1] - P[0]))


def _orthogonal_error(P, sel, rms):
    """An error [n, 3], zero outside `sel`, whose columns are orthogonal to
    the ones and to P's columns over `sel`: the Umeyama fit of P + error
    onto P is then the identity, and the SE3-aligned ATE is `rms`."""
    rs = np.random.RandomState(0)
    basis = np.concatenate([np.ones((len(sel), 1)), P[sel]], 1)
    q, _ = np.linalg.qr(basis)
    e = rs.normal(size=(len(sel), 3))
    e -= q @ (q.T @ e)
    e *= rms / np.sqrt((e ** 2).sum(1).mean())
    out = np.zeros_like(P)
    out[sel] = e
    return out


def _line(gate):
    return bench_torch.bench_line("m", 30.0, gate["ok"], {})


@pytest.mark.parametrize("case,ok", [
    ("pass", True), ("ate_4.99%", True), ("vio_never_up", False), ("79%_working", False),
    ("ate_5.01%", False), ("6_after_init+3", True), ("5_after_init+3", False)])
def test_vip_gate(case, ok):
    n, init = 100, 30
    if case.endswith("after_init+3"):
        n, init = 20, 20 - 3 - int(case[0])
    states = np.full(n, WORKING)
    states[:2] = INITIALIZING
    if case == "79%_working":
        states[:21] = INITIALIZING
    vio = np.arange(n) >= init
    if case == "vio_never_up":
        vio[:] = False
    P, span = _path(n)
    sel = np.arange(init + 3, n)
    ratio = {"ate_4.99%": 0.0499, "ate_5.01%": 0.0501}.get(case, 0.01)
    C = P + _orthogonal_error(P, sel, ratio * span)
    gate = bench_torch.vip_gate(states, vio, C, P)
    assert gate["ok"] is ok
    if case.startswith("ate"):
        assert gate["ate_metric_m"] == pytest.approx(ratio * span, rel=1e-9)
    line = _line(gate)
    assert (line["value"], line["vs_baseline"]) == ((30.0, 1.5) if ok else (0.0, 0.0))
    assert line["extra"]["ok"] is ok


@pytest.mark.parametrize("case,ok", [("pass", True), ("ate_1.99%", True),
                                     ("79%_working", False), ("ate_2.01%", False)])
def test_mono_gate(case, ok):
    """The Sim3 fit of P + e, e orthogonal to P, scales by s = g / (g + p)
    (g, p: mean squared spreads of P and e) and leaves an ATE of
    sqrt(g p / (g + p)); e is sized for the ATE asked."""
    n = 60
    states = np.full(n, WORKING)
    states[:3] = INITIALIZING
    if case == "79%_working":
        states[:13] = INITIALIZING
    P, span = _path(n)
    sel = np.nonzero(states == WORKING)[0]
    a = {"ate_1.99%": 0.0199, "ate_2.01%": 0.0201}.get(case, 0.005) * span
    g = ((P[sel] - P[sel].mean(0)) ** 2).sum(1).mean()
    C = P + _orthogonal_error(P, sel, np.sqrt(a * a * g / (g - a * a)))
    gate = bench_torch.mono_gate(states, C, P)
    assert gate["ok"] is ok
    assert gate["ate_threshold_m"] == pytest.approx(0.02 * span)
    if case.startswith("ate"):
        assert gate["ate_m"] == pytest.approx(a, rel=1e-6)
    line = _line(gate)
    assert (line["value"], line["vs_baseline"]) == ((30.0, 1.5) if ok else (0.0, 0.0))


@pytest.mark.parametrize("case,ok", [("linear", True), ("flat", False), ("stalled", False),
                                     ("init_in_second_half", True),
                                     ("init_in_first_half", True)])
def test_plausibility(case, ok):
    """bench.py once published 0.78 ms for a 120-frame run: a clock that
    does not grow with the frames ("flat": the 60-frame run takes as long)
    is refused, as is one that grows 3x faster than the frames it times;
    a linear one passes, also with a 40x VIO-init frame in either half."""
    n, ms = 120, 300.0
    frame_ms = [5000.0] + [ms] * (n - 1)
    init = {"init_in_second_half": 70, "init_in_first_half": 30}.get(case, -1)
    if init >= 0:
        frame_ms[init] = 40 * ms
    wall = sum(frame_ms)
    half = frame_ms[:n // 2]
    half_wall = sum(half)
    if case == "flat":
        frame_ms, half = [0.78 / n] * n, [0.78 / n] * (n // 2)
        wall = half_wall = 0.78
    if case == "stalled":
        wall = half_wall + 3 * ms * (n - n // 2)
    p = bench_torch.plausibility(frame_ms, wall, half, half_wall, init)
    assert p["within_band"] is ok
    if ok:
        assert p["marginal_ms_per_frame"] == pytest.approx(ms)
        assert p["ratio"] == pytest.approx(1.0)


def _run_bench(args, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO, **(env_extra or {}))
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=600)


EXTRA_KEYS = {"ok", "frames_tracked", "n_frames", "wall_ms_per_frame", "run_wall_ms",
              "ms_per_frame", "run_medians_ms",
              "first_frame_ms", "runs_bitwise_equal", "host_reads_per_frame",
              "hand_kernel_launches_per_frame", "refine_wide_calls", "peak_allocated_mib",
              "compactions",
              "plausibility", "profile", "device"}


def test_tiny_cpu_run_prints_both_lines():
    code = ("import sys, torch\n"
            "torch.set_num_threads(1)\n"
            "import bench_torch\n"
            "sys.exit(bench_torch.main(['--device', 'cpu', '--frames', '4', '--reps', '2'],"
            " H=96, W=128))\n")
    r = _run_bench(["-c", code])
    assert r.returncode == 0, r.stdout + r.stderr
    lines = [json.loads(x) for x in r.stdout.strip().splitlines()]
    assert len(lines) == 2
    vip, mono = lines
    assert "VIP" in vip["metric"] and "mono" in mono["metric"]
    for line, more in ((vip, {"vio_init_frame", "ate_metric_m", "vio_init_frame_ms"}),
                       (mono, {"ate_m", "ate_threshold_m", "dispatch_rtt_ms"})):
        assert line["metric"].startswith("PyTorch/CUDA port") and "CPU" in line["metric"]
        assert set(line) == {"metric", "value", "unit", "vs_baseline", "extra"}
        assert line["unit"] == "fps"
        extra = line["extra"]
        assert EXTRA_KEYS | more <= set(extra), (EXTRA_KEYS | more) - set(extra)
        assert extra["n_frames"] == 4 and extra["device"] == "cpu"
        assert extra["runs_bitwise_equal"] is True
        assert len(extra["run_medians_ms"]) == 2 and extra["ms_per_frame"] > 0
        assert len(extra["run_wall_ms"]) == 2
        assert extra["wall_ms_per_frame"] == pytest.approx(
            float(np.median(extra["run_wall_ms"])) / 4, rel=1e-12)
        assert extra["plausibility"]["half_run_bitwise_equal"] is True
        assert extra["plausibility"]["half_run_frames"] == 2
        assert {"within_band", "marginal_ms_per_frame", "second_half_median_ms",
                "ratio"} <= set(extra["plausibility"])
        # the CPU run measures no device: no device numbers, no kernel launches
        assert extra["profile"] is None and extra["peak_allocated_mib"] is None
        assert extra["refine_wide_calls"] == 0
        assert set(extra["hand_kernel_launches_per_frame"]) == {"extract_patches",
                                                                "anchor_refine"}
    assert mono["extra"]["dispatch_rtt_ms"] is None
    # 4 frames: VIO cannot initialize (vio_init_min_time 1 s = 20 frames)
    assert vip["extra"]["vio_init_frame"] == -1 and vip["value"] == 0.0


def test_no_card_no_run():
    r = _run_bench([os.path.join(REPO, "bench_torch.py"), "--mode", "mono", "--frames", "4"],
                   {"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert r.stdout == "" and "no CUDA device" in r.stderr
