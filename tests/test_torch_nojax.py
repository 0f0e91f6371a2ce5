"""The port stands alone: importing every uvipslam_torch module pulls in
neither jax nor the reference package, and the constants the port
regenerates (BRIEF pattern, vocabulary, haloc projections) and its
synthetic camera sequences equal the reference's bit for bit."""

import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest

import uvipslam_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _all_modules():
    return sorted(m.name for m in pkgutil.walk_packages(uvipslam_torch.__path__,
                                                         "uvipslam_torch."))


def test_import_every_module_without_jax():
    mods = _all_modules()
    assert "uvipslam_torch.kernels" in mods and "uvipslam_torch.frontend.device_tracker" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
            "             or k == 'uvipslam_tpu' or k.startswith('uvipslam_tpu.'))\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith("ok")


def test_regenerated_constants_equal_reference():
    from uvipslam_tpu.loop import haloc as jhaloc, reloc as jreloc
    from uvipslam_tpu.ops import orb as jorb
    from uvipslam_torch.loop import haloc as thaloc, reloc as treloc
    from uvipslam_torch.ops import orb as torb

    np.testing.assert_array_equal(torb.BRIEF_PATTERN, jorb.BRIEF_PATTERN)
    assert torb.BRIEF_PATTERN.dtype == jorb.BRIEF_PATTERN.dtype
    np.testing.assert_array_equal(treloc.CODEBOOK, jreloc._CODEBOOK)
    np.testing.assert_array_equal(treloc.IDF, jreloc._IDF)
    assert treloc.N_WORDS == jreloc.N_WORDS
    for n in (100, 400):
        np.testing.assert_array_equal(thaloc._projections(n), jhaloc._projections(n))
    assert thaloc.HASH_DIM == jhaloc.HASH_DIM


@pytest.mark.parametrize("motion", ["arc", "excited", "loop", "circuit", "forward"])
def test_synthetic_sequence_equals_reference(motion):
    from uvipslam_tpu.io import synthetic as jsyn
    from uvipslam_torch.io import synthetic as tsyn

    kw = dict(n_frames=4, H=48, W=64, n_points=300, seed=5, motion=motion, speed=1.2)
    j = jsyn.make_sequence(**kw)
    t = tsyn.make_sequence(**kw)
    for f in ("images", "timestamps", "R_cw", "t_cw", "K", "points", "positions_w"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
    assert t.images.dtype == j.images.dtype
    est = j.positions_w + np.random.RandomState(0).normal(0, 0.01, j.positions_w.shape)
    for scale in (True, False):
        a_t, al_t = tsyn.ate_rmse(est, j.positions_w, scale)
        a_j, al_j = jsyn.ate_rmse(est, j.positions_w, scale)
        assert a_t == a_j
        np.testing.assert_array_equal(al_t, al_j)
