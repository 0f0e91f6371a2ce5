"""IMU recovery of the VIP slice: the port's device VIP step against the
reference's on tests/test_torch_vip.py's sequence (120x160, 100 tracks,
40 frames), with three black frames after VIO init. Both steps fail the
VI solve and its first-try lane, dead-reckon in IMU_RELOC, and come back
to WORKING by two-view re-anchoring within two frames of each other.

This pass was the second half of tests/test_torch_vip.py's module
fixtures; it lives in a file of its own so that two test workers share
the two sequence passes. The port's pass runs eager and graphed (the
plain CPU form of its segments and scans), which must agree bit for bit
through the recovery: its re-integration replayed through
`Segments.scan`, its window BA tail as segments. The same sequence at a
small `pt_cap` drives the landmark-table compaction inside segment E, of
the single step and of the fleet, against the reference's
`device_hygiene`.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from uvipslam_tpu.frontend import device_vip as jdv
from uvipslam_tpu.frontend import vip_tracker as jvt
from uvipslam_tpu.models.camera import CameraModel as JCam
from uvipslam_torch.core.tree import stack_streams, tree_map
from uvipslam_torch.frontend import device_vip as tdv
from uvipslam_torch.frontend import tracker as ttr
from uvipslam_torch.frontend import vip_tracker as tvt
from uvipslam_torch.models.camera import CameraModel as TCam
from tests.test_torch_step import _leaves, hygiene_against_reference, hygiene_spy
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_vip import CFG, H, KF_CAP, N_FRAMES, PT_CAP, W, _jbundle, seq  # noqa: F401

BLACK = (28, 29, 30)     # black frames after VIO init (frame 23 in both)
# the compaction runs: at this capacity the landmark table passes 90% on
# the pre-VIO keyframe of frame 15 and on the VI keyframe of frame 27
COMPACT_PT_CAP, COMPACT_FRAMES = 120, 28


@pytest.fixture(autouse=True)
def _f32_mode():
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def jax_blackout(seq):
    with jax.enable_x64(False):
        cam = JCam.create(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], width=W,
                          height=H)
        st, step = jdv.build_vip_tracker(cam, jvt.VipConfig(**CFG), KF_CAP, PT_CAP)
        states = []
        for f in range(N_FRAMES):
            b = _jbundle(seq, f)
            if f in BLACK:
                b = dataclasses.replace(b, img=jnp.zeros_like(b.img))
            st, out = step(st, b)
            states.append(int(out.state))
    return np.asarray(states)


def _cam(seq):
    return TCam.create(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], width=W, height=H)


@pytest.fixture(scope="module")
def torch_blackout_forms(seq):
    """The port's blackout pass eager (`graphs=False`) and graphed: per
    frame the label, the output and the state; the step."""
    runs = {}
    for graphs in (False, True):
        st, step = tdv.build_vip_tracker(_cam(seq), tvt.VipConfig(**CFG), KF_CAP, PT_CAP,
                                         device="cpu", graphs=graphs)
        states, trees = [], []
        for f, b in enumerate(tdv.make_bundles(seq, device="cpu")):
            if f in BLACK:
                b = dataclasses.replace(b, img=torch.zeros_like(b.img))
            st, out = step(st, b)
            states.append(int(out.state))
            trees.append((out, st))
        runs[graphs] = dict(states=np.asarray(states), trees=trees, step=step)
    return runs


@pytest.fixture(scope="module")
def torch_blackout(torch_blackout_forms):
    return torch_blackout_forms[False]["states"]


def test_vi_blackout_enters_and_leaves_imu_recovery(jax_blackout, torch_blackout):
    """Black frames after VIO init: the VI solve and its first-try lane
    fail, both steps dead-reckon in IMU_RELOC, capture a fresh anchor and
    re-anchor by two-view reconstruction back to WORKING. Before the
    blackout the port's states are the reference's."""
    runs = {"reference": jax_blackout, "port": torch_blackout}
    first = {}
    for name, states in runs.items():
        assert (states[:BLACK[0]] == jax_blackout[:BLACK[0]]).all(), (name, states)
        assert states[BLACK[0]] == ttr.IMU_RELOC, (name, states)
        rec = np.nonzero(states[BLACK[0]:] == ttr.WORKING)[0]
        assert len(rec) and (states[BLACK[0] + rec[0]:] == ttr.WORKING).all(), (name, states)
        first[name] = BLACK[0] + int(rec[0])
    assert abs(first["reference"] - first["port"]) <= 2, (first, runs)


def _same_bits(a, b):
    return all(torch.equal(x.contiguous().view(-1).view(torch.uint8),
                           y.contiguous().view(-1).view(torch.uint8))
               for (_, x), (_, y) in zip(_leaves(a), _leaves(b)))


def test_graphed_blackout_equals_eager_through_recovery(jax_blackout, torch_blackout_forms):
    """The blackout pass graphed (the plain CPU form) against eager: every
    frame's output and state bit for bit with the same host reads, through
    the recovery frame, whose two stored windows are re-integrated through
    `Segments.scan` (key ("scan", "preint", (2, window))) and whose window
    BA runs as the tail's segments BA and E; the bootstrap's BA tail too
    (BA, E before VIO init and R). Its labels pass the reference checks of
    `test_vi_blackout_enters_and_leaves_imu_recovery`."""
    e, g = torch_blackout_forms[False], torch_blackout_forms[True]
    for f, (a, b) in enumerate(zip(e["trees"], g["trees"])):
        assert _same_bits(a, b), f
    assert e["step"].host_syncs == g["step"].host_syncs
    assert e["step"].compactions == g["step"].compactions == 0
    keys = g["step"].segments.keys
    assert {("BA", False, False), ("E", False, False), ("R",), ("BA", True, False),
            ("E", True, False), ("scan", "preint", (2, CFG["imu_cap_per_kf"]))} <= keys, keys
    test_vi_blackout_enters_and_leaves_imu_recovery(jax_blackout, g["states"])


def test_compaction_inside_segment_e(seq, monkeypatch):
    """The VIP step at a `pt_cap` small enough that the landmark table
    passes 90% of it, before VIO init and after: the compaction runs inside
    segment E, keyed by its read (("E", False, True), ("E", True, True)).
    The graphed step (its plain CPU form) gives the eager step's outputs
    and states bit for bit with the same host reads and compactions;
    `compactions` counts the frames whose read asked for one; on each, the
    map and tracks after the frame equal the reference's `device_hygiene`
    on the inputs of that keyframe's hygiene."""
    tag = [None]
    calls = hygiene_spy(monkeypatch, tdv, tag)
    bundles = tdv.make_bundles(seq, device="cpu")[:COMPACT_FRAMES]
    runs = {}
    for graphs in (False, True):
        st, step = tdv.build_vip_tracker(_cam(seq), tvt.VipConfig(**CFG), KF_CAP,
                                         COMPACT_PT_CAP, device="cpu", graphs=graphs)
        trees, compacted = [], []
        for f, b in enumerate(bundles):
            tag[0] = (graphs, f)
            n0 = step.compactions
            st, out = step(st, b)
            trees.append((out, dataclasses.replace(st, gen=None)))
            if step.compactions > n0:
                compacted.append((f, bool(out.vio_ok)))
        runs[graphs] = trees, compacted, step
    (e_trees, e_comp, e_step), (g_trees, g_comp, g_step) = runs[False], runs[True]
    for f, (a, b) in enumerate(zip(e_trees, g_trees)):
        assert _same_bits(a, b), f
    assert e_step.host_syncs == g_step.host_syncs and e_comp == g_comp
    assert e_step.compactions == len(e_comp) and {v for _, v in e_comp} == {False, True}, e_comp
    assert {("E", False, True), ("E", True, True)} <= g_step.segments.keys
    for f, _ in e_comp:
        inputs = [x for t, x in calls if t == (False, f)][-1]
        st = e_trees[f][1]
        assert hygiene_against_reference(inputs, st.map, st.tracks, _cam(seq)), f


def test_fleet_compaction_inside_segment_e(seq):
    """The VIP fleet over two streams of the sequence (generators seeded
    apart) at the small `pt_cap`: the rows whose compaction read holds are
    compacted inside segment E (its group `full`), and the fleet counts
    them. The graphed fleet (its plain CPU form) gives the eager fleet's
    outputs and states bit for bit with the same host reads and
    compactions. In the eager fleet, the compactions of each frame are the
    keyframe rows whose hygiene input passes 90% of the table (the
    reference's condition), and on each such row the map and tracks after
    the frame equal the reference's `device_hygiene` on that input (the
    BA's rows, from D's own BA with the hygiene left out)."""
    cfg = tvt.VipConfig(**CFG)
    bundles = tdv.make_bundles(seq, device="cpu")[:17]
    runs, hyg = {}, []
    for graphs in (False, True):
        fleet = tdv.VipFleetStep(_cam(seq), cfg, KF_CAP, device="cpu", graphs=graphs)
        if not graphs:
            real = fleet._ba_front

            def ba_front(st, adopt, ix, vio_ok, hygiene, real=real):
                if hygiene:     # the hygiene's inputs: the same BA without it
                    pre = real(st, adopt, ix=ix, vio_ok=vio_ok, hygiene=False)[0]
                    hyg.append((ix["g"], tree_map(torch.clone, pre)))
                return real(st, adopt, ix=ix, vio_ok=vio_ok, hygiene=hygiene)

            fleet._ba_front = ba_front
        st0 = tdv.init_vip_state(cfg, KF_CAP, COMPACT_PT_CAP, H, W, device="cpu")
        st = stack_streams([dataclasses.replace(st0, gen=None)] * 2)
        gens = [torch.Generator().manual_seed(i) for i in (0, 1)]
        trees, counts, checked = [], [], 0
        for f, b in enumerate(bundles):
            n0, k0 = fleet.compactions, len(hyg)
            st, out = fleet(st, stack_streams([b, b]), gens)
            trees.append((out, st))
            counts.append(fleet.compactions - n0)
            for g, pre in hyg[k0:]:
                rows = range(2) if isinstance(g, str) else g.tolist()    # ALL or rows
                for j, i in enumerate(rows):
                    if int(pre.map.n_pt[j]) > int(0.9 * COMPACT_PT_CAP):
                        counts[-1] -= 1
                        row = tree_map(lambda a, j=j: a[j], pre)
                        checked += hygiene_against_reference(
                            (row.map, row.tracks, row.frame_id, row.Rcw, row.tcw),
                            tree_map(lambda a, i=i: a[i], st.map),
                            tree_map(lambda a, i=i: a[i], st.tracks), _cam(seq))
        runs[graphs] = trees, counts, fleet, checked
    (e_trees, e_counts, e_fleet, checked), (g_trees, _, g_fleet, _) = runs[False], runs[True]
    for f, (a, b) in enumerate(zip(e_trees, g_trees)):
        assert _same_bits(a, b), f
    assert e_fleet.host_syncs == g_fleet.host_syncs and e_fleet.compactions == g_fleet.compactions
    # every frame's compactions are the rows the reference compacts
    assert e_counts == [0] * len(bundles) and e_fleet.compactions == checked > 0
    assert any(k[0] == "E" and ("full", "none") not in k for k in g_fleet.segments.keys)
