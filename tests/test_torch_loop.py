"""Parity of the port's loop-closing components with the reference on
seeded numpy inputs, on the CPU: the Sim3 factors, the map's covisibility
queries, keyframe culling and duplicate fusion, the haloc / BoW candidate
ranking (with ties), DBSCAN clustering and the keyframe clusters. The
solvers are in test_torch_loop_solvers.py.

Tolerances: integer, mask and index outputs are exact. Closed-form float32
results agree to float32 rounding (atol 1e-5 on unit-scale values, 2e-4 on
Jacobian entries, which reach tens; float64 Jacobians 1e-9).
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from uvipslam_tpu.loop import clusters as jclusters
from uvipslam_tpu.loop import dbscan as jdbscan
from uvipslam_tpu.loop import haloc as jhaloc
from uvipslam_tpu.loop import vocab as jvocab
from uvipslam_tpu.mapstate import hygiene as jhyg
from uvipslam_tpu.mapstate.map import MapState as JMap
from uvipslam_tpu.ops import hamming as jham
from uvipslam_tpu.solver import factors as jfac
from uvipslam_torch import convert
from uvipslam_torch.loop import clusters as tclusters
from uvipslam_torch.loop import dbscan as tdbscan
from uvipslam_torch.loop import haloc as thaloc
from uvipslam_torch.loop import vocab as tvocab
from uvipslam_torch.mapstate import hygiene as thyg
from uvipslam_torch.ops import hamming as tham
from uvipslam_torch.solver import factors as tfac
from tests.test_torch_threads import one_torch_thread  # noqa: F401

FX, FY, CX, CY = 400.0, 400.0, 320.0, 240.0
DTYPES = {"f32": (np.float32, torch.float32, False), "f64": (np.float64, torch.float64, True)}


@pytest.fixture(autouse=True)
def _f32_mode():
    with jax.enable_x64(False):
        yield


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tree_np(obj):
    return jax.tree_util.tree_map(np.asarray, obj)


def _rot(rs, scale, n):
    """[n, 3, 3] float64 rotations of angle ~ scale."""
    w = rs.randn(n, 3) * scale
    th = np.linalg.norm(w, axis=1)[:, None, None]
    K = np.zeros((n, 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -w[:, 2], w[:, 1], -w[:, 0]
    K = K - K.transpose(0, 2, 1)
    return np.eye(3) + np.sin(th) / th * K + (1 - np.cos(th)) / th**2 * K @ K


def _sim3s(rs, n, npdt, rot=0.4):
    return (np.exp(rs.randn(n) * 0.1).astype(npdt), _rot(rs, rot, n).astype(npdt),
            rs.randn(n, 3).astype(npdt))


# ---------------------------------------------------------------------------
# Sim3 factors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dkey", ["f32", "f64"])
def test_sim3_relative_residual_and_jacobians(dkey):
    """The port takes the 7x14 Jacobian by forward mode like the
    reference: float64 agrees to 1e-9, float32 to 2e-4 (entries reach
    tens)."""
    npdt, tdt, x64 = DTYPES[dkey]
    rs = np.random.RandomState(0)
    args = _sim3s(rs, 9, npdt) + _sim3s(rs, 9, npdt) + _sim3s(rs, 9, npdt)
    with jax.enable_x64(x64):
        j = [np.asarray(a) for a in jax.jit(jfac.sim3_relative)(*(jnp.asarray(a) for a in args))]
    t = tfac.sim3_relative(*(_t(a) for a in args))
    t1 = tfac.sim3_relative(*(_t(a)[0] for a in args))       # one edge, no batch dimension
    atol = 1e-9 if x64 else 2e-4
    for a, b, a1 in zip(t, j, t1):
        assert a.dtype == tdt and a.shape == b.shape and a1.shape == b.shape[1:]
        np.testing.assert_allclose(_np(a), b, atol=atol, rtol=0)
        np.testing.assert_allclose(_np(a1), b[0], atol=atol, rtol=0)


def test_sim3_reproj():
    rs = np.random.RandomState(1)
    s, R, t = (a[0] for a in _sim3s(rs, 1, np.float32))     # one Sim3, a batch of points
    pw = (rs.randn(11, 3) + [0, 0, 5]).astype(np.float32)
    uv = (rs.rand(11, 2) * 400).astype(np.float32)
    j = jfac.sim3_reproj(jnp.asarray(s), jnp.asarray(R), jnp.asarray(t), jnp.asarray(pw),
                         jnp.asarray(uv), FX, FY, CX, CY)
    p = tfac.sim3_reproj(_t(s), _t(R), _t(t), _t(pw), _t(uv), FX, FY, CX, CY)
    for a, b in zip(p, j):
        # pixel-scale residuals and Jacobians (hundreds): relative 1e-5
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5, atol=1e-3)


# ---------------------------------------------------------------------------
# map queries, keyframe culling, duplicate fusion
# ---------------------------------------------------------------------------

def _random_map(K=7, P=96, F=40, seed=2, dup=False):
    """A reference MapState in numpy: K-1 valid keyframes observing random
    landmarks (some features unmapped or invalid, the dump row P-1
    genuinely observed once), random positions; with `dup`, chains of
    near-coincident landmarks with equal descriptors."""
    rs = np.random.RandomState(seed)
    m = _tree_np(JMap.empty(K, P, F, imu_window=4))
    feat_pt = rs.randint(0, P - 1, (K, F)).astype(np.int32)
    feat_pt[rs.rand(K, F) < 0.2] = -1
    feat_pt[2, 5] = P - 1
    feat_valid = rs.rand(K, F) < 0.9
    kf_valid = np.ones(K, bool)
    kf_valid[K - 2] = False
    pt_valid = rs.rand(P) < 0.9
    pt_valid[P - 1] = True
    xyz = rs.uniform(-2, 2, (P, 3)).astype(np.float32)
    desc = rs.randint(0, 2, (P, 256)).astype(np.int8)
    if dup:
        for a, b in ((10, 3), (20, 10), (30, 20), (41, 40), (50, 3)):   # 30 -> 20 -> 10 -> 3
            xyz[a] = xyz[b] + np.float32(0.01)
            desc[a] = desc[b]
            pt_valid[[a, b]] = True
        xyz[60] = xyz[61] + np.float32(0.01)           # near, descriptors differ
    prev = np.arange(-1, K - 1).astype(np.int32)
    return dataclasses.replace(
        m, kf_feat_pt=feat_pt, kf_feat_valid=feat_valid, kf_valid=kf_valid, pt_valid=pt_valid,
        pt_xyz=xyz, pt_desc=desc, kf_prev=prev, n_kf=np.asarray(K, np.int32),
        n_pt=np.asarray(P, np.int32))


def test_covisibility_queries_exact():
    m = _random_map()
    jm = jax.tree_util.tree_map(jnp.asarray, m)
    tm = convert.map_state(m)
    np.testing.assert_array_equal(_np(tm.covisibility_matrix()),
                                  np.asarray(jm.covisibility_matrix()))
    rs = np.random.RandomState(3)
    for kf_mask in (np.eye(7, dtype=bool)[2], np.eye(7, dtype=bool)[0], rs.rand(7) < 0.5,
                    np.zeros(7, bool)):
        jp = np.asarray(jm.points_seen_by(jnp.asarray(kf_mask)))
        tp = tm.points_seen_by(_t(kf_mask))
        np.testing.assert_array_equal(_np(tp), jp)
        np.testing.assert_array_equal(_np(tm.covisibility_with(tp)),
                                      np.asarray(jm.covisibility_with(jnp.asarray(jp))))
    # the dump row: seen through keyframe 2 only
    assert bool(tm.points_seen_by(_t(np.eye(7, dtype=bool)[2]))[-1])
    assert not bool(tm.points_seen_by(_t(np.eye(7, dtype=bool)[0]))[-1])
    pmask = rs.rand(96) < 0.5
    for a, b in zip(tm.observations_of(_t(pmask)), jm.observations_of(jnp.asarray(pmask))):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_add_loop_edge():
    m = _random_map()
    jm = jax.tree_util.tree_map(jnp.asarray, m)
    tm = convert.map_state(m)
    rs = np.random.RandomState(4)
    for n in range(18):      # past LOOP_CAP: the last slot is overwritten
        s, R, t = _sim3s(rs, 1, np.float32)
        jm = jm.add_loop_edge(jnp.asarray(n % 5), jnp.asarray(6), jnp.asarray(s[0]),
                              jnp.asarray(R[0]), jnp.asarray(t[0]))
        tm = tm.add_loop_edge(n % 5, 6, _t(s[0]), _t(R[0]), _t(t[0]))
    for f in ("loop_i", "loop_j", "loop_s", "loop_R", "loop_t", "n_loop"):
        np.testing.assert_array_equal(_np(getattr(tm, f)), np.asarray(getattr(jm, f)), err_msg=f)
        assert getattr(tm, f).dtype == getattr(convert.map_state(_tree_np(jm)), f).dtype


def test_cull_keyframes_exact():
    from tests.test_global_ba import build_map

    jm, _, _ = build_map(pose_noise=0.0, pt_noise=0.0)
    tm = convert.map_state(_tree_np(jm))
    for _ in range(3):
        jm, tm = jhyg.cull_keyframes(jm), thyg.cull_keyframes(tm)
        for f in ("kf_valid", "kf_prev", "kf_feat_valid"):
            np.testing.assert_array_equal(_np(getattr(tm, f)), np.asarray(getattr(jm, f)),
                                          err_msg=f)
    assert int(tm.kf_valid.sum()) == 4
    # a random map with few shared observations culls nothing on either side
    m = _random_map()
    t2 = thyg.cull_keyframes(convert.map_state(m))
    j2 = jhyg.cull_keyframes(jax.tree_util.tree_map(jnp.asarray, m))
    np.testing.assert_array_equal(_np(t2.kf_valid), np.asarray(j2.kf_valid))


@pytest.mark.parametrize("block", [1024, 32])
def test_fuse_duplicates_exact(block):
    """Exact masks and ids, whatever the row block; the chain 30 -> 20 ->
    10 -> 3 resolves to 3."""
    m = _random_map(dup=True)
    j = jhyg.fuse_duplicates(jax.tree_util.tree_map(jnp.asarray, m))
    t = thyg.fuse_duplicates(convert.map_state(m), block=block)
    np.testing.assert_array_equal(_np(t.pt_valid), np.asarray(j.pt_valid))
    np.testing.assert_array_equal(_np(t.kf_feat_pt), np.asarray(j.kf_feat_pt))
    assert not _np(t.pt_valid)[[10, 20, 30, 41, 50]].any() and _np(t.pt_valid)[[3, 40, 60]].all()
    assert not np.isin(_np(t.kf_feat_pt), [10, 20, 30, 41, 50]).any()


# ---------------------------------------------------------------------------
# retrieval: haloc, BoW (with ties)
# ---------------------------------------------------------------------------

def _retrieval_inputs(seed=5, K=12):
    rs = np.random.RandomState(seed)
    hashes = rs.randn(K, jhaloc.HASH_DIM).astype(np.float32)
    hashes[7] = hashes[3]            # a tie: slots 3 and 7 at the same distance
    hashes[9] = hashes[3]
    bows = rs.rand(K, 64).astype(np.float32)
    bows /= bows.sum(1, keepdims=True)
    bows[8] = bows[4]
    bows[2] = bows[4]
    valid = np.ones(K, bool)
    valid[5] = False
    exclude = np.zeros(K, bool)
    exclude[[0, 1]] = True
    return hashes, bows, valid, exclude


@pytest.mark.parametrize("q", [3, 4, 10])
def test_haloc_candidates_exact_with_ties(q):
    hashes, _, valid, exclude = _retrieval_inputs()
    np.testing.assert_allclose(
        _np(thaloc.hash_distance(_t(hashes[q]), _t(hashes))),
        np.asarray(jhaloc.hash_distance(jnp.asarray(hashes[q]), jnp.asarray(hashes))),
        rtol=1e-6)
    ex = exclude.copy()
    ex[q] = True
    for top_k in (3, 5):
        j = jhaloc.detect_candidates_haloc(jnp.asarray(hashes[q]), jnp.asarray(hashes),
                                           jnp.asarray(valid), jnp.asarray(ex), top_k=top_k)
        t = thaloc.detect_candidates_haloc(_t(hashes[q]), _t(hashes), _t(valid), _t(ex),
                                           top_k=top_k)
        np.testing.assert_array_equal(_np(t[0]), np.asarray(j[0]))
        np.testing.assert_allclose(_np(t[1]), np.asarray(j[1]), rtol=1e-6)
        np.testing.assert_array_equal(_np(t[2]), np.asarray(j[2]))
    # everything excluded: infinite distances, slots in index order, none ok
    allx = np.ones_like(valid)
    j = jhaloc.detect_candidates_haloc(jnp.asarray(hashes[q]), jnp.asarray(hashes),
                                       jnp.asarray(valid), jnp.asarray(allx))
    t = thaloc.detect_candidates_haloc(_t(hashes[q]), _t(hashes), _t(valid), _t(allx))
    np.testing.assert_array_equal(_np(t[0]), np.asarray(j[0]))
    assert not _np(t[2]).any() and not np.asarray(j[2]).any()


@pytest.mark.parametrize("q", [4, 6])
def test_bow_candidates_exact_with_ties(q):
    _, bows, valid, exclude = _retrieval_inputs()
    ex = exclude.copy()
    ex[q] = True
    j = jvocab.detect_candidates(jnp.asarray(bows[q]), jnp.asarray(bows), jnp.asarray(valid),
                                 jnp.asarray(ex), jnp.asarray(0.3, jnp.float32), top_k=8)
    t = tvocab.detect_candidates(_t(bows[q]), _t(bows), _t(valid), _t(ex), 0.3, top_k=8)
    np.testing.assert_array_equal(_np(t[0]), np.asarray(j[0]))
    np.testing.assert_allclose(_np(t[1]), np.asarray(j[1]), atol=1e-6)
    np.testing.assert_array_equal(_np(t[2]), np.asarray(j[2]))
    rs = np.random.RandomState(6)
    desc = rs.randint(0, 2, (50, 256)).astype(np.int8)
    cb = rs.randint(0, 2, (32, 256)).astype(np.int8)
    np.testing.assert_array_equal(_np(tvocab.bow_words(_t(desc), _t(cb))),
                                  np.asarray(jvocab.bow_words(jnp.asarray(desc), jnp.asarray(cb))))


def test_level_mask():
    rs = np.random.RandomState(7)
    a, b = rs.randint(0, 8, 20).astype(np.int32), rs.randint(0, 8, 30).astype(np.int32)
    np.testing.assert_array_equal(_np(tham.level_mask(_t(a), _t(b))),
                                  np.asarray(jham.level_mask(jnp.asarray(a), jnp.asarray(b))))


# ---------------------------------------------------------------------------
# DBSCAN and the keyframe clusters
# ---------------------------------------------------------------------------

def _blobs(seed, n=120):
    """Three pixel blobs of different sizes (two of them linked by a thin
    bridge of border points), scattered noise and a few invalid points."""
    rs = np.random.RandomState(seed)
    xy = np.concatenate([
        rs.randn(45, 2) * 12 + [100, 100], rs.randn(35, 2) * 12 + [400, 120],
        rs.randn(20, 2) * 10 + [250, 380], rs.uniform(0, 640, (n - 100, 2))]).astype(np.float32)
    perm = rs.permutation(n)
    valid = np.ones(n, bool)
    valid[rs.choice(n, 8, replace=False)] = False
    return xy[perm], valid


@pytest.mark.parametrize("seed,min_pts", [(8, 10), (9, 10), (8, 25), (8, 200)])
def test_dbscan_labels_exact(seed, min_pts):
    xy, valid = _blobs(seed)
    jl, jc = jdbscan.dbscan_labels(jnp.asarray(xy), jnp.asarray(valid), eps=50.0,
                                   min_pts=min_pts)
    tl, tc = tdbscan.dbscan_labels(_t(xy), _t(valid), eps=50.0, min_pts=min_pts)
    np.testing.assert_array_equal(_np(tl), np.asarray(jl))
    np.testing.assert_array_equal(_np(tc), np.asarray(jc))
    assert tl.dtype == torch.int32
    xyz = np.random.RandomState(seed).randn(xy.shape[0], 3).astype(np.float32)
    j = jdbscan.cluster_centroids(jnp.asarray(xyz), jl, 6)
    t = tdbscan.cluster_centroids(_t(xyz), tl, 6)
    np.testing.assert_array_equal(_np(t[2]), np.asarray(j[2]))
    live = np.asarray(j[2]) > 0
    np.testing.assert_array_equal(_np(t[0])[live], np.asarray(j[0])[live])
    np.testing.assert_allclose(_np(t[1])[live], np.asarray(j[1])[live], atol=1e-5)


@pytest.mark.parametrize("min_pts", [10, 100])
def test_keyframe_clusters(min_pts):
    """Exact counts; hashes (sums of up to F unit-projection terms) within
    1e-4, centroids within 1e-5. min_pts 100 takes the one-cluster
    fallback."""
    xy, valid = _blobs(10)
    F, P, K = xy.shape[0], 200, 3
    rs = np.random.RandomState(11)
    m = _tree_np(JMap.empty(K, P, F, imu_window=4))
    feat_pt = rs.permutation(P)[:F].astype(np.int32)
    feat_pt[~valid] = -1
    m = dataclasses.replace(
        m, kf_feat_xy=np.stack([xy] * K), kf_feat_pt=np.stack([feat_pt] * K),
        kf_feat_valid=np.ones((K, F), bool),
        kf_feat_desc=rs.randint(0, 2, (K, F, 256)).astype(np.int8),
        pt_xyz=rs.randn(P, 3).astype(np.float32), pt_valid=np.ones(P, bool))
    j = jclusters.keyframe_clusters(jax.tree_util.tree_map(jnp.asarray, m), 1, min_pts=min_pts)
    t = tclusters.keyframe_clusters(convert.map_state(m), 1, min_pts=min_pts)
    np.testing.assert_array_equal(_np(t[2]), np.asarray(j[2]))
    np.testing.assert_allclose(_np(t[0]), np.asarray(j[0]), atol=1e-4)
    np.testing.assert_allclose(_np(t[1]), np.asarray(j[1]), atol=1e-5)
    assert int(t[2][0]) > 0 and (min_pts == 10) == (int(t[2][1]) > 0)
    for name in ("CLUSTERS_PER_KF", "EPS_PX", "MIN_PTS", "HALOC_ID_WINDOW", "PROX_ID_WINDOW",
                 "HALOC_BEST_N", "PROX_BEST_N"):
        assert getattr(tclusters, name) == getattr(jclusters, name)
