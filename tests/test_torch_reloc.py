"""Relocalization and CLAHE in the port against the reference: CLAHE, PnP
RANSAC, the first-try projection associations, BoW + PnP
relocalization, and the mono step's LOST branch and `enhance=True`
against `uvipslam_tpu.frontend.device_tracker` (120x160, 100 tracks).

Tolerances: CLAHE agrees to atol 1e-3 on the 0-255 scale. PnP RANSAC and
`relocalize_frame` draw their minimal samples from jax.random in the
reference and from a torch.Generator in the port, so the port is fed the
reference's own draws (`idx`); then inlier sets are equal and poses
agree to 1e-4. Descriptor matching is exact, so association ids, counts
and the retrieved keyframes are equal. The blackout test compares
outcomes: after three black frames both steps are LOST, and within three
frames of the last keyframe's image both are WORKING with the camera
centre within 0.15 of that keyframe's (the bound of
tests/test_device_vip.py::test_device_vip_relocalizes_after_preinit_blackout).
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from uvipslam_tpu.core import lie as jlie
from uvipslam_tpu.frontend import device_tracker as jdt
from uvipslam_tpu.frontend import tracker as jtr
from uvipslam_tpu.io.synthetic import make_sequence
from uvipslam_tpu.loop import reloc as jreloc
from uvipslam_tpu.models.camera import CameraModel as JCam
from uvipslam_tpu.ops import clahe as jclahe
from uvipslam_tpu.ops import pnp as jpnp
from uvipslam_tpu.ops import twoview as jtv
from uvipslam_torch import convert
from uvipslam_torch.frontend import device_tracker as tdt
from uvipslam_torch.frontend import tracker as ttr
from uvipslam_torch.loop import reloc as treloc
from uvipslam_torch.models.camera import CameraModel as TCam
from uvipslam_torch.ops import clahe as tclahe
from uvipslam_torch.ops import pnp as tpnp
from tests.test_torch_threads import one_torch_thread  # noqa: F401

CFG = dict(n_tracks=100, min_init_tracks=60, local_window=8)
KF_CAP, PT_CAP = 16, 1024
WARMUP = 16          # frames tracked before the blackout
ATOL = 1e-4


@pytest.fixture(autouse=True)
def _f32_mode():
    with jax.enable_x64(False):
        yield


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _texture(h, w, seed):
    rs = np.random.RandomState(seed)
    img = np.kron(rs.uniform(40, 220, (h // 8 + 1, w // 8 + 1)), np.ones((8, 8)))[:h, :w]
    return np.clip(img + rs.uniform(-5, 5, (h, w)), 0, 255).astype(np.float32)


@pytest.mark.parametrize("shape", [(120, 160), (512, 640)])
def test_clahe(shape):
    """512x640 does not divide by the 12x12 grid: reflect-101 padding to
    516x648, as the reference pads."""
    img = _texture(*shape, seed=shape[0])
    j = np.asarray(jclahe.clahe(jnp.asarray(img)))
    t = tclahe.clahe(torch.from_numpy(img)).numpy()
    assert t.shape == img.shape and t.dtype == np.float32
    np.testing.assert_allclose(t, j, atol=1e-3, rtol=0)
    assert t.std() > img.std()


def _pnp_scene():
    """tests/test_loop_components.py::TestPnP: 200 points, 60 outliers."""
    rs = np.random.RandomState(7)
    pts = rs.uniform(-2, 2, (200, 3)) + [0, 0, 6]
    Rcw = np.asarray(jlie.so3_exp(jnp.asarray([0.2, -0.3, 0.1])), np.float64)
    tcw = np.array([0.4, -0.2, 0.8])
    pc = pts @ Rcw.T + tcw
    uv = np.stack([420 * pc[:, 0] / pc[:, 2] + 320, 420 * pc[:, 1] / pc[:, 2] + 240], -1)
    uv += rs.randn(200, 2) * 0.5
    uv[rs.choice(200, 60, replace=False)] += rs.uniform(30, 100, (60, 2))
    valid = np.ones(200, bool)
    valid[rs.choice(200, 10, replace=False)] = False
    return pts.astype(np.float32), uv.astype(np.float32), valid, Rcw, tcw


def test_pnp_ransac_injected_samples():
    pts, uv, valid, Rcw, tcw = _pnp_scene()
    key = jax.random.PRNGKey(1)
    idx = np.asarray(jtv._sample_minimal(key, 128, 6, jnp.asarray(valid)))
    Rj, tj, inl_j, n_j = jpnp.pnp_ransac(key, jnp.asarray(pts), jnp.asarray(uv),
                                         jnp.asarray(valid), 420.0, 420.0, 320.0, 240.0)
    Rt, tt, inl_t, n_t = tpnp.pnp_ransac(None, torch.from_numpy(pts), torch.from_numpy(uv),
                                         torch.from_numpy(valid), 420.0, 420.0, 320.0, 240.0,
                                         idx=torch.from_numpy(idx))
    np.testing.assert_array_equal(_np(inl_t), _np(inl_j))
    assert int(n_t) == int(n_j) > 100
    np.testing.assert_allclose(_np(Rt), _np(Rj), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(tt), _np(tj), atol=ATOL, rtol=0)
    # the port's own draws find the pose too
    g = torch.Generator().manual_seed(0)
    Rg, tg, _, ng = tpnp.pnp_ransac(g, torch.from_numpy(pts), torch.from_numpy(uv),
                                    torch.from_numpy(valid), 420.0, 420.0, 320.0, 240.0)
    assert int(ng) > 100
    np.testing.assert_allclose(_np(Rg), Rcw, atol=0.02)
    assert np.linalg.norm(_np(tg) - tcw) < 0.1


# ---------------------------------------------------------------------------
# carried mono state and the blackout
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def seq():
    return make_sequence(n_frames=20, H=120, W=160, n_points=800, seed=3, speed=1.2)


def _feeds(seq):
    """WARMUP frames, three black frames, then the last keyframe's image
    (frame index resolved by the runner) three times."""
    black = np.zeros_like(seq.images[0], np.float32)
    return [seq.images[f].astype(np.float32) for f in range(WARMUP)] + [black] * 3


def _kf_image_runs(step_fn, st, seq, kf_frame):
    states, C = [], []
    for _ in range(3):
        st, state, Rcw, tcw = step_fn(st, seq.images[kf_frame].astype(np.float32))
        states.append(state)
        C.append(-np.asarray(Rcw, np.float64).T @ np.asarray(tcw, np.float64))
        if state == jtr.WORKING:
            break
    return states, C


@pytest.fixture(scope="module")
def jax_run(seq):
    cam = JCam.create(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], width=160, height=120)
    with jax.enable_x64(False):
        st, step = jdt.build_tracker(cam, jtr.TrackerConfig(**CFG), KF_CAP, PT_CAP)

        def step_fn(st, img):
            st, out = step(st, jnp.asarray(img))
            return st, int(out.state), np.asarray(out.Rcw), np.asarray(out.tcw)

        states = []
        for f, img in enumerate(_feeds(seq)):
            st, s, _, _ = step_fn(st, img)
            states.append(s)
            if f == WARMUP - 1:
                carried = jax.tree_util.tree_map(np.asarray, st)
        k = int(st.map.n_kf) - 1
        kf_frame = int(st.map.kf_frame_id[k])
        C_kf = np.asarray(st.map.kf_ns.p[k], np.float64)
        rec_states, C = _kf_image_runs(step_fn, st, seq, kf_frame)
    return dict(cam=cam, carried=carried, states=states, kf_frame=kf_frame, C_kf=C_kf,
                rec_states=rec_states, C=C)


@pytest.fixture(scope="module")
def torch_run(seq):
    cam = TCam.create(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], width=160, height=120)
    st, step = tdt.build_tracker(cam, ttr.TrackerConfig(**CFG), KF_CAP, PT_CAP, device="cpu")

    def step_fn(st, img):
        st, out = step(st, torch.from_numpy(img))
        return st, int(out.state), out.Rcw.numpy(), out.tcw.numpy()

    states = []
    for img in _feeds(seq):
        st, s, _, _ = step_fn(st, img)
        states.append(s)
    k = int(st.map.n_kf) - 1
    kf_frame = int(st.map.kf_frame_id[k])
    C_kf = st.map.kf_ns.p[k].double().numpy()
    rec_states, C = _kf_image_runs(step_fn, st, seq, kf_frame)
    return dict(cam=cam, states=states, kf_frame=kf_frame, C_kf=C_kf, rec_states=rec_states,
                C=C)


def test_mono_blackout_relocalizes(jax_run, torch_run):
    for run in (jax_run, torch_run):
        assert run["states"][WARMUP - 1] == ttr.WORKING, run["states"]
        assert run["states"][-1] == ttr.LOST, run["states"]
        assert run["rec_states"][-1] == ttr.WORKING, run["rec_states"]
        err = np.linalg.norm(run["C"][-1] - run["C_kf"])
        assert err < 0.15, (err, run["C"][-1], run["C_kf"])
    assert jax_run["kf_frame"] == torch_run["kf_frame"]
    # the LOST branch no longer keeps LOST: both recover on the same frame
    assert len(jax_run["rec_states"]) == len(torch_run["rec_states"])


@pytest.mark.parametrize("min_matches", [30, 1000], ids=["narrow", "wide"])
def test_first_try_associations(jax_run, torch_run, min_matches):
    src = jax_run["carried"]
    st = convert.tracker_state(src)
    cj, ct = jax_run["cam"], torch_run["cam"]
    pid_j, n_j = jreloc.first_try_associations(
        jax.tree_util.tree_map(jnp.asarray, src.tracks),
        jax.tree_util.tree_map(jnp.asarray, src.map), jnp.asarray(src.last_kf_slot),
        jnp.asarray(src.Rcw), jnp.asarray(src.tcw), cj.fx, cj.fy, cj.cx, cj.cy,
        min_matches=min_matches)
    pid_t, n_t = treloc.first_try_associations(
        st.tracks, st.map, st.last_kf_slot, st.Rcw, st.tcw, ct.fx, ct.fy, ct.cx, ct.cy,
        min_matches=min_matches)
    np.testing.assert_array_equal(_np(pid_t), _np(pid_j))
    assert int(n_t) == int(n_j) >= 20


def test_relocalize_frame_injected_samples(jax_run, torch_run):
    """The carried frame's tracks against its own map: the same top-3
    keyframes, and with the reference's draws fed to the port the same
    associations and pose."""
    src = jax_run["carried"]
    st = convert.tracker_state(src)
    cj, ct = jax_run["cam"], torch_run["cam"]
    key = jax.random.PRNGKey(3)
    Rj, tj, pid_j, n_j, top_j = jreloc.relocalize_frame(
        jax.tree_util.tree_map(jnp.asarray, src.tracks),
        jax.tree_util.tree_map(jnp.asarray, src.map), key, cj.fx, cj.fy, cj.cx, cj.cy)
    keys = jax.random.split(key, treloc.N_CANDIDATES)
    idx = []
    for c in range(treloc.N_CANDIDATES):
        _, _, cand = treloc.candidate_matches(st.tracks, st.map, torch.tensor(int(top_j[c])))
        idx.append(torch.from_numpy(np.asarray(jtv._sample_minimal(
            keys[c], treloc.PNP_ITERS, 6, jnp.asarray(cand.numpy())))))
    Rt, tt, pid_t, n_t, top_t = treloc.relocalize_frame(
        st.tracks, st.map, None, ct.fx, ct.fy, ct.cx, ct.cy, idx=torch.stack(idx))
    np.testing.assert_array_equal(_np(top_t), _np(top_j))
    np.testing.assert_array_equal(_np(pid_t), _np(pid_j))
    assert int(n_t) == int(n_j) >= 20
    np.testing.assert_allclose(_np(Rt), _np(Rj), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(tt), _np(tj), atol=ATOL, rtol=0)
    # the frame's own pose, recovered from the map alone
    C = -_np(Rt).astype(np.float64).T @ _np(tt).astype(np.float64)
    C_true = -src.Rcw.astype(np.float64).T @ src.tcw.astype(np.float64)
    assert np.linalg.norm(C - C_true) < 0.05


def test_relocalize_frame_ties_rank_lower_slot_first(jax_run, torch_run):
    """With fewer than three valid keyframes the -1 scores tie; both
    sides then rank the lower slot first."""
    src = jax_run["carried"]
    kf_valid = np.zeros_like(src.map.kf_valid)
    kf_valid[:2] = src.map.kf_valid[:2]
    m = dataclasses.replace(src.map, kf_valid=kf_valid)
    cj = jax_run["cam"]
    *_, top_j = jreloc.relocalize_frame(
        jax.tree_util.tree_map(jnp.asarray, src.tracks), jax.tree_util.tree_map(jnp.asarray, m),
        jax.random.PRNGKey(0), cj.fx, cj.fy, cj.cx, cj.cy)
    st = convert.tracker_state(dataclasses.replace(src, map=m))
    g = torch.Generator().manual_seed(0)
    ct = torch_run["cam"]
    *_, top_t = treloc.relocalize_frame(st.tracks, st.map, g, ct.fx, ct.fy, ct.cx, ct.cy)
    np.testing.assert_array_equal(_np(top_t), _np(top_j))
    assert sorted(_np(top_t)[:2].tolist()) == [0, 1]


def test_enhance_frame0_tracks_equal(seq):
    """enhance=True runs CLAHE before the pyramid: the first frame's
    tracks equal the reference's."""
    img = seq.images[0].astype(np.float32)
    cfg = dict(CFG, enhance=True)
    cam_j = JCam.create(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], width=160, height=120)
    st_j, step_j = jdt.build_tracker(cam_j, jtr.TrackerConfig(**cfg), KF_CAP, PT_CAP)
    st_j, _ = step_j(st_j, jnp.asarray(img))
    cam_t = TCam.create(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], width=160, height=120)
    st_t, step_t = tdt.build_tracker(cam_t, ttr.TrackerConfig(**cfg), KF_CAP, PT_CAP,
                                    device="cpu")
    st_t, _ = step_t(st_t, torch.from_numpy(img))
    tj, tt = st_j.tracks, st_t.tracks
    for f in ("xy", "desc", "level", "valid", "birth_frame"):
        np.testing.assert_array_equal(_np(getattr(tt, f)), _np(getattr(tj, f)), err_msg=f)
    for f in ("tpl", "tpl2"):
        np.testing.assert_allclose(_np(getattr(tt, f)), _np(getattr(tj, f)), atol=1e-3, rtol=0,
                                   err_msg=f)
    assert int(np.sum(_np(tt.valid))) > 50
    # the enhanced frame's tracks differ from the plain frame's
    st_p, step_p = tdt.build_tracker(cam_t, ttr.TrackerConfig(**CFG), KF_CAP, PT_CAP,
                                    device="cpu")
    st_p, _ = step_p(st_p, torch.from_numpy(img))
    assert not torch.equal(st_p.tracks.xy, tt.xy)
