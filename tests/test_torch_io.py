"""The port's host I/O against the reference's: settings, TUM trajectory
files, the ATE evaluation, the metrics stream, the rosbag decoder and the
per-frame sensor bundles, and map checkpoints both ways.

The port carries copies of these jax-free host modules (it imports nothing
of the reference package), so each copy is held to the reference's output
on the same input: settings field by field, TUM files byte for byte,
alignments and ATE within 1e-12, the metrics JSONL row by row apart from
its wall-clock fields, decoded bags and bundles bit for bit. A map saved
by either package loads in the other, equal leaf by leaf.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from tests._bagwrite import imu_stream_from_sequence, write_bag
from tests.test_bag_decoder import write_tiny_bag, write_tiny_bag_bz2
from tests.test_config_io import REFERENCE_YAML
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from uvipslam_torch import convert
from uvipslam_torch.io import bag as tbag
from uvipslam_torch.io import checkpoint as tck
from uvipslam_torch.io import config as tcfg
from uvipslam_torch.io import evaluate as tev
from uvipslam_torch.io import trajectory as ttraj
from uvipslam_torch.io.synthetic import make_sequence
from uvipslam_torch.mapstate.map import MapState as TMap
from uvipslam_torch.utils.metrics import MetricsLogger as TLogger
from uvipslam_tpu.io import bag as jbag
from uvipslam_tpu.io import config as jcfg
from uvipslam_tpu.io import evaluate as jev
from uvipslam_tpu.io import trajectory as jtraj
from uvipslam_tpu.utils.metrics import MetricsLogger as JLogger

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

# the VIP settings of tests/test_parity_harness.py: Camera.Tbc as an
# !!opencv-matrix, IMU noise, the init mode
OPENCV_MATRIX_YAML = """%YAML:1.0
Camera.fx: 207.5
Camera.fy: 207.25
Camera.cx: 160.0
Camera.cy: 120.5
Camera.col: 320
Camera.row: 240
Camera.fps: 20.0
Camera.Tbc: !!opencv-matrix
   rows: 4
   cols: 4
   dt: d
   data: [0.97, -0.2, 0.11, 0.08, 0.21, 0.976, -0.05, -0.05, -0.1, 0.07, 0.99, 0.07,
          0.0, 0.0, 0.0, 1.0]
gyr.noise: 0.01
acc.noise: 0.1
gyr.rw: 5.0e-5
acc.rw: 1.0e-3
depth.noise: 0.05
ORBextractor.nFeatures: 200
LocalMapping.LocalWindowSize: 6
Mode: 2
Enhance: 1
LoopC: 0
time.Init: 2.5
Init_mode: 2
imagetopic: "/camera/image_raw"
imutopic: "/imu"
depthtopic: "/depth"
"""


def _same_settings(a, b):
    assert [f.name for f in dataclasses.fields(a)] == [f.name for f in dataclasses.fields(b)]
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(y, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
            assert x.dtype == y.dtype, f.name
        else:
            assert type(x) is type(y) and x == y, (f.name, x, y)


@pytest.mark.parametrize("text", [REFERENCE_YAML, OPENCV_MATRIX_YAML, None],
                         ids=["harbor", "opencv-matrix", "defaults"])
def test_settings_equal_field_by_field(tmp_path, text):
    if text is None:
        _same_settings(tcfg.Settings(), jcfg.Settings())
        assert tcfg.Settings().mode == tcfg.VIP == jcfg.VIP
        return
    p = tmp_path / "settings.yaml"
    p.write_text(text)
    t, j = tcfg.load_settings(str(p)), jcfg.load_settings(str(p))
    _same_settings(t, j)
    assert (tcfg.MONO, tcfg.VI, tcfg.VIP) == (jcfg.MONO, jcfg.VI, jcfg.VIP)
    if text is OPENCV_MATRIX_YAML:
        assert t.Tbc[0, 1] == -0.2 and t.Tbc[2, 3] == 0.07


def _rotations(n, seed):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        q = rs.randn(4)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        out.append(np.asarray([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]]))
    return out


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_tum_files_byte_equal(tmp_path, dtype):
    rs = np.random.RandomState(0)
    n = 12
    ts = 100.0 + np.arange(n) * 0.05
    Rs = [R.astype(dtype) for R in _rotations(n, 1)]
    # near-identity and 180-degree turns take the quaternion's other branches
    Rs[0] = np.eye(3, dtype=dtype)
    Rs[1] = np.diag([-1.0, -1.0, 1.0]).astype(dtype)
    Rs[2] = np.diag([1.0, -1.0, -1.0]).astype(dtype)
    tvs = [rs.randn(3).astype(dtype) for _ in range(n)]
    pt, pj = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    ttraj.save_tum_trajectory(pt, ts, Rs, tvs)
    jtraj.save_tum_trajectory(pj, ts, Rs, tvs)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    for a, b in zip(ttraj.load_tum_trajectory(pj), jtraj.load_tum_trajectory(pj)):
        np.testing.assert_array_equal(a, b)
    gt_t, gt_j = str(tmp_path / "gt_t.txt"), str(tmp_path / "gt_j.txt")
    P = rs.randn(n, 3)
    tev.save_tum_groundtruth(gt_t, ts, P)
    jev.save_tum_groundtruth(gt_j, ts, P)
    assert open(gt_t, "rb").read() == open(gt_j, "rb").read()


def test_evaluate_units_equal():
    """tests/test_parity_harness.py::TestEvaluateUnits's inputs."""
    ts_e = np.asarray([0.0, 1.0, 2.0, 3.0])
    ts_g = np.asarray([0.005, 1.2, 2.001, 2.996])
    for a, b in zip(tev.associate(ts_e, ts_g, max_dt=0.02), jev.associate(ts_e, ts_g, max_dt=0.02)):
        np.testing.assert_array_equal(a, b)
    rs = np.random.RandomState(0)
    P = rs.randn(50, 3)
    th = 0.7
    R = np.asarray([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1.0]])
    G = 2.5 * (R @ P.T).T + [1.0, -2.0, 0.5]
    for with_scale in (True, False):
        for a, b in zip(tev.umeyama_alignment(P, G, with_scale=with_scale),
                        jev.umeyama_alignment(P, G, with_scale=with_scale)):
            np.testing.assert_allclose(a, b, atol=1e-12, rtol=0)
    rs = np.random.RandomState(1)
    P = rs.randn(40, 3)
    Rx = np.asarray([[1.0, 0, 0], [0, np.cos(0.2), -np.sin(0.2)], [0, np.sin(0.2), np.cos(0.2)]])
    for G in ((Rx @ P.T).T, P + [0.3, 0.1, -0.2]):
        for a, b in zip(tev.posyaw_alignment(P, G), jev.posyaw_alignment(P, G)):
            np.testing.assert_allclose(a, b, atol=1e-12, rtol=0)


@pytest.mark.parametrize("align", ["sim3", "se3", "posyaw", "none"])
def test_evaluate_ate_equal(tmp_path, align):
    ts = np.arange(20) * 0.05
    gt = np.stack([np.linspace(0, 2, 20), 0.3 * np.sin(ts), np.zeros(20)], 1)
    est = 0.5 * gt + np.asarray([3.0, 1.0, 0.0])
    est[7] += [0.0, 0.02, 0.0]
    gt_f, est_f = str(tmp_path / "gt.txt"), str(tmp_path / "est.txt")
    jev.save_tum_groundtruth(gt_f, ts, gt)
    jev.save_tum_groundtruth(est_f, ts + 0.003, est)
    t = tev.evaluate_ate(est_f, gt_f, align=align)
    j = jev.evaluate_ate(est_f, gt_f, align=align)
    assert t.keys() == j.keys()
    for k in j:
        if isinstance(j[k], float):
            assert abs(t[k] - j[k]) <= 1e-12, (k, t[k], j[k])
        else:
            assert t[k] == j[k], k


def _log(cls, path):
    ml = cls(path, run_id="t", flush_every=3)
    ml.frame(0, {"state": "WORKING", "n_inliers": 42, "arr": [1, 2], "ok": True})
    with ml.timer("local_ba", kf=3):
        pass
    ml.counter("keyframes")
    ml.counter("keyframes", 2.5)
    for f in range(1, 5):
        ml.frame(f, {"state": "LOST" if f == 3 else "WORKING", "x": 0.5 * f})
    ml.event("run_end", fps=12.5, n_keyframes=4)
    summary = ml.summary()
    ml.close()
    return summary


def test_metrics_jsonl_equal(tmp_path):
    pt, pj = str(tmp_path / "t.jsonl"), str(tmp_path / "j.jsonl")
    st, sj = _log(TLogger, pt), _log(JLogger, pj)
    clock = ("t", "dur_s", "wall_s")

    def rows(p):
        return [{k: v for k, v in json.loads(ln).items() if k not in clock} for ln in open(p)]

    assert rows(pt) == rows(pj)
    assert len(rows(pt)) == 8
    assert {k: v for k, v in st.items() if k not in clock} == \
        {k: v for k, v in sj.items() if k not in clock}


@pytest.fixture(scope="module")
def vip_bag(tmp_path_factory):
    """A rendered 8-frame sequence with IMU and pressure as a bag."""
    seq = make_sequence(n_frames=8, H=48, W=64, n_points=300, seed=5, speed=1.2,
                        gyr_noise=0.005, acc_noise=0.05, depth_noise=0.02, z_amp=0.5)
    imu_ts, omg, acc = imu_stream_from_sequence(seq)
    path = str(tmp_path_factory.mktemp("bag") / "seq.bag")
    pressure = seq.depth[seq.depth_valid].copy()
    pressure[3] += 5.0                    # an outlier for the clamp
    write_bag(path, seq.images, seq.timestamps, imu_ts=imu_ts, imu_omg=omg, imu_acc=acc,
              pressure_ts=seq.timestamps[seq.depth_valid], pressure=pressure)
    return path


def _same_bag(a, b):
    for f in ("imu", "pressure", "image_times", "images"):
        x, y = getattr(a, f), getattr(b, f)
        np.testing.assert_array_equal(x, y, err_msg=f)
        assert x.dtype == y.dtype, f


def _bags(tmp_path, vip_bag):
    tiny, bz2 = str(tmp_path / "tiny.bag"), str(tmp_path / "bz2.bag")
    write_tiny_bag(tiny)
    write_tiny_bag_bz2(bz2)
    return tiny, bz2, vip_bag


def test_read_bag_and_bundles_bit_equal(tmp_path, vip_bag):
    topics = ("/camera/image_raw", "/imu", "/depth")
    for path in _bags(tmp_path, vip_bag):
        t, j = tbag.read_bag(path, *topics), jbag.read_bag(path, *topics)
        _same_bag(t, j)
        for kw in (dict(), dict(delay_to_imu=-0.004), dict(imu_per_frame_cap=8),
                   dict(depth_outlier_clamp=0.5)):
            bt, bj = tbag.make_frame_bundles(t, **kw), jbag.make_frame_bundles(j, **kw)
            assert bt.keys() == bj.keys()
            for k in bj:
                np.testing.assert_array_equal(bt[k], bj[k], err_msg=f"{k} {kw}")
                assert np.asarray(bt[k]).dtype == np.asarray(bj[k]).dtype, k
    with pytest.raises(ValueError):
        junk = tmp_path / "junk.bag"
        junk.write_bytes(b"not a bag at all")
        tbag.read_bag(str(junk), *topics)


def test_bag_reader_built_from_source(tmp_path, vip_bag, monkeypatch):
    """Where the repo's prebuilt decoder does not load, the port compiles
    native/bagreader.cpp into its own build directory (never into
    native/); that library decodes the same arrays."""
    native = sorted(os.listdir(os.path.join(ROOT, "native")))
    path = tbag.build_reader()
    assert os.path.dirname(path) == tbag.BUILD_DIR and os.path.exists(path)
    assert sorted(os.listdir(os.path.join(ROOT, "native"))) == native
    assert tbag.build_reader() == path               # cached by source and flags
    monkeypatch.setattr(tbag, "_LIB", tbag._bind(path))
    topics = ("/camera/image_raw", "/imu", "/depth")
    for p in _bags(tmp_path, vip_bag):
        _same_bag(tbag.read_bag(p, *topics), jbag.read_bag(p, *topics))


def _reference_map():
    """A small reference map with landmarks and keyframes in it."""
    import jax
    import jax.numpy as jnp

    from uvipslam_tpu.core.preintegration import PreintState
    from uvipslam_tpu.core.state import NavState
    from uvipslam_tpu.mapstate.map import MapState

    rs = np.random.RandomState(4)
    m = MapState.empty(4, 16, 8)
    m, _ = m.add_points(jnp.asarray(rs.randn(8, 3), jnp.float32),
                        jnp.asarray(rs.randint(0, 2, (8, 256)), jnp.int8),
                        jnp.asarray(rs.randn(8, 3), jnp.float32),
                        jnp.full((8,), 0.5), jnp.full((8,), 4.0), jnp.asarray(0),
                        jnp.asarray(3), jnp.asarray(rs.rand(8) > 0.3))
    for k in range(3):
        ns = dataclasses.replace(NavState.identity((), jnp.float32),
                                 p=jnp.asarray(rs.randn(3), jnp.float32))
        m, _ = m.add_keyframe(
            ns, jnp.asarray(0.1 * k), jnp.asarray(k, jnp.int32),
            jnp.asarray(rs.rand(8, 2) * 50, jnp.float32),
            jnp.asarray(rs.randint(0, 2, (8, 256)), jnp.int8), jnp.zeros(8, jnp.int32),
            jnp.asarray(rs.rand(8), jnp.float32), jnp.ones(8, bool),
            jnp.arange(8, dtype=jnp.int32), jnp.asarray(1.5 + k), jnp.asarray(True),
            jax.tree_util.tree_map(lambda a: a[0], PreintState.zero((1,))),
            jnp.asarray(k - 1, jnp.int32))
    return m


def test_checkpoint_reference_save_loads_in_port(tmp_path):
    from uvipslam_tpu.io import checkpoint as jck

    m = _reference_map()
    p = str(tmp_path / "map.npz")
    jck.save_map(p, m)
    t = tck.load_map(p, TMap.empty(4, 16, 8), device="cpu")
    want = convert.map_state(m)
    from tests.test_torch_step import _leaves
    got, ref = dict(_leaves(t)), dict(_leaves(want))
    assert got.keys() == ref.keys() and len(got) > 40
    for name, a in ref.items():
        assert got[name].dtype == a.dtype, name
        assert torch.equal(got[name], a), name
    assert int(t.n_kf) == 3 and int(t.n_pt) > 0
    with pytest.raises(ValueError):
        tck.load_map(p, TMap.empty(4, 32, 8), device="cpu")     # another capacity
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tck.load_map(p, TMap.empty(4, 16, 8))                  # the card by default


def test_checkpoint_port_save_loads_in_reference(tmp_path):
    import jax

    from uvipslam_tpu.io import checkpoint as jck
    from uvipslam_tpu.mapstate.map import MapState

    t = convert.map_state(_reference_map())
    p = str(tmp_path / "map.npz")
    tck.save_map(p, t)
    j = jck.load_map(p, MapState.empty(4, 16, 8))
    from uvipslam_torch.core.tree import tree_leaves
    jl = jax.tree_util.tree_leaves(j)
    tl = tree_leaves(t)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert np.asarray(a).dtype == b.numpy().dtype
