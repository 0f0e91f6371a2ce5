"""`correct` on the CPU at a small size: the harness's whole run (no look
for a chip) with the program's timed path broken underneath comes out
false, once for each fault a cell can have; and the control, the plain
reference in TF32 in the program's place, fails the numbers the sound
program passes. One chip per cell, so no exchange between chips to leave
out. The card's test runs the control at the cells' own sizes."""

import json
import os
import subprocess
import sys

import pytest
import torch

import run
from conftest import BENCH, ROOT
from uvipslam_torch.core.tree import tree_map

# what decides each fault at this size: the small runs track less well
# than the cells' (their ATE may miss the cells' gates), so each fault is
# held to the number it must move
TRACKING = ("not_working_share",)


def small(which, streams, frames):
    with open(os.path.join(BENCH, "configs", f"aqualoc_harbor_{which}.json")) as fh:
        conf = json.load(fh)
    conf["sequence"].update(H=96, W=128, n_points=600)
    traffic = dict(streams=streams, frames=frames, judged_frames_per_dive=6,
                   scene_seeds=[7, 8] if streams == 1 else [7, 8, 9])
    return conf, traffic


class Broken:
    """The program's step with its result changed by `how(st_in, st, out)`."""

    def __init__(self, step, how):
        self.step, self.how = step, how

    def __getattr__(self, name):
        return getattr(self.step, name)

    def __call__(self, st, *args):
        new, out = self.step(st, *args)
        return self.how(st, new, out)


def drive(which, streams, frames, how=None):
    """(checks, control checks) of one small run on the CPU."""
    conf, traffic = small(which, streams, frames)
    lines = []

    def on_entry(entry):
        if how is not None:
            entry.step = Broken(entry.step, how)

    res = run.run_cell(conf, traffic, [11], 0.0, device="cpu", sink=lines.append,
                       on_entry=on_entry)
    checks = {k: (v["value"], v["limit"]) for k, v in res["checks"].items()}
    return checks, lines[0]["control"], res["correct"]


def failed(checks):
    return {k for k, (v, lim) in checks.items() if not (isinstance(v, float) and v <= lim)}


@pytest.fixture(scope="module")
def sound_mono():
    return drive("mono", 1, 30)


@pytest.fixture(scope="module")
def sound_vip():
    return drive("vip", 1, 40)


@pytest.mark.parametrize("which", ["mono", "vip"])
def test_control_fails_what_the_program_passes(which, sound_mono, sound_vip):
    checks, control, _ = sound_mono if which == "mono" else sound_vip
    exact = [k for k in checks if k.startswith(("preint", "template", "kf_depth", "refine"))]
    assert exact
    assert not failed({k: checks[k] for k in exact})
    ctrl = {k: (control[k], checks[k][1]) for k in exact}
    assert failed(ctrl) == set(exact)


def test_state_left_unchanged_is_not_correct(sound_mono):
    assert not failed({k: sound_mono[0][k] for k in TRACKING})
    checks, _, correct = drive("mono", 1, 30, how=lambda st, new, out: (st, out))
    assert not correct and "not_working_share" in failed(checks)


def test_half_the_fleet_left_out_is_not_correct():
    """The second half of the streams takes the first half's rows: their
    templates no longer come from their own images."""

    def half(st, new, out):
        S = new.state.shape[0]
        h = S // 2

        def copy_rows(a):
            return torch.cat([a[:S - h], a[:h]]) if a.dim() and a.shape[0] == S else a

        return tree_map(copy_rows, new), tree_map(copy_rows, out)

    sound, _, _ = drive("mono", 2, 30)
    assert "template_gap" not in failed(sound)
    checks, _, correct = drive("mono", 2, 30, how=half)
    assert not correct and "template_gap" in failed(checks)


def test_pose_altered_is_not_correct(sound_vip):
    """The VIP pose scaled by 2 where the step makes it: the metric ATE
    fails."""
    import dataclasses

    assert "ate_span_share" not in failed(sound_vip[0])
    checks, _, correct = drive("vip", 1, 40, how=lambda st, new, out: (
        new, dataclasses.replace(out, tcw=out.tcw * 2.0)))
    assert not correct and "ate_span_share" in failed(checks)


def test_template_altered_is_not_correct(sound_mono):
    """A track's birth template off by half a gray level where the step
    makes it."""
    import dataclasses

    def shift(st, new, out):
        return dataclasses.replace(new, tracks=dataclasses.replace(
            new.tracks, tpl=new.tracks.tpl + 0.5)), out

    checks, _, correct = drive("mono", 1, 30, how=shift)
    assert not correct and "template_gap" in failed(checks)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["vip.dive", "mono.fleet8", "mono.dive"])
def test_control_fails_on_the_card(card, cell):
    """The control at the cell's own size on three seeds: the program
    correct, the reference in TF32 in its place not."""
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell,
                          "--seconds", "1", "--seeds", "901,902,903"], cwd=ROOT,
                         capture_output=True, text=True, timeout=1800)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(x) for x in out.stdout.splitlines() if x.startswith('{"seed"')]
    assert len(lines) == 3
    for line in lines:
        assert line["correct"] and not line["control_correct"], line


def test_window_ba_left_out_is_not_correct(sound_mono, monkeypatch):
    """The mono window BA returns its inputs and keeps every observation:
    the map it leaves breaks the BA's bound."""
    from uvipslam_torch.frontend import tracker

    def skipped(kf_R, kf_t, kf_fixed, kf_valid, pts_w, pt_valid, obs_kf, obs_pt, obs_uv,
                obs_inv_sigma2, obs_mask, *args, **kw):
        return kf_R, kf_t, pts_w, obs_mask

    assert "ba_kept_chi2" not in failed(sound_mono[0])
    monkeypatch.setattr(tracker, "local_ba_se3", skipped)
    checks, _, correct = drive("mono", 1, 30)
    assert not correct and "ba_kept_chi2" in failed(checks)


def test_refined_positions_altered_is_not_correct(sound_vip):
    """The tracks' positions off by a hundredth of a pixel where the
    propagation makes them."""
    import dataclasses

    def shift(st, new, out):
        return dataclasses.replace(new, tracks=dataclasses.replace(
            new.tracks, xy=new.tracks.xy + 0.01)), out

    assert "refine_gap" not in failed(sound_vip[0])
    checks, _, correct = drive("vip", 1, 40, how=shift)
    assert not correct and "refine_gap" in failed(checks)
