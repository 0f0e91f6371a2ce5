"""The port's host-side drawing (`viz/publishers.py`) against the
reference's, on the inputs of tests/test_config_io.py::test_viz_draw.

`draw_tracked_frame` gives the reference's image bit for bit, from numpy
arrays and from tensors. `plot_map` writes its figure for an empty map and
for a populated one (the reference's map carried over with
`uvipslam_torch.convert`: keyframes on a line, covisibility, spanning
tree, frustum); `save_frame_png` writes a PNG, or a PPM without
matplotlib. The figures need matplotlib and skip only where it is missing.
"""

import dataclasses
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from uvipslam_tpu.core.state import NavState as JNav
from uvipslam_tpu.mapstate.map import MapState as JMap
from uvipslam_tpu.viz import publishers as jviz
from uvipslam_torch import convert
from uvipslam_torch.mapstate.map import MapState as TMap
from uvipslam_torch.viz import publishers as tviz
from tests.test_torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _f32_mode():
    with jax.enable_x64(False):
        yield


def _frame():
    img = np.random.RandomState(0).uniform(0, 255, (48, 64)).astype(np.float32)
    xy = np.asarray([[10.0, 10.0], [30.0, 20.0], [0.4, 5.0], [62.6, 40.0], [40.0, 30.0]])
    return img, xy, np.asarray([True, True, True, True, False]), \
        np.asarray([True, False, True, False, True])


@pytest.mark.parametrize("as_tensors", [False, True])
def test_draw_tracked_frame_equals_reference(as_tensors):
    img, xy, valid, has_point = _frame()
    ref = jviz.draw_tracked_frame(img, xy, valid, has_point)
    args = (img, xy, valid, has_point)
    if as_tensors:
        args = tuple(torch.from_numpy(np.asarray(a)) for a in args)
    got = tviz.draw_tracked_frame(*args)
    assert got.dtype == ref.dtype == np.uint8 and got.shape == (48, 64, 3)
    np.testing.assert_array_equal(got, ref)
    assert (got[10, 10] == (0, 255, 0)).all() and (got[20, 30] == (255, 160, 0)).all()


def _populated_reference_map():
    """tests/test_config_io.py's populated map: three keyframes 0.1 apart
    on x, each seeing the same eight landmarks."""
    m = JMap.empty(4, 16, 8)
    m = dataclasses.replace(m, pt_valid=m.pt_valid.at[:8].set(True),
                            n_pt=jnp.asarray(8, jnp.int32))
    for k in range(3):
        ns = dataclasses.replace(JNav.identity((), jnp.float32),
                                 p=jnp.asarray([0.1 * k, 0.0, 0.0]))
        m, _ = m.add_keyframe(
            ns, jnp.asarray(float(k)), jnp.asarray(k, jnp.int32),
            jnp.zeros((8, 2)), jnp.zeros((8, 256), jnp.int8), jnp.zeros(8, jnp.int32),
            jnp.zeros(8), jnp.ones(8, bool), jnp.arange(8, dtype=jnp.int32),
            jnp.asarray(0.0), jnp.asarray(False),
            jax.tree_util.tree_map(lambda a: a[0], m.kf_preint), jnp.asarray(k - 1, jnp.int32))
    return m


def test_plot_map_writes_both_figures(tmp_path):
    pytest.importorskip("matplotlib")
    tviz.plot_map(str(tmp_path / "map.png"), TMap.empty(4, 16, 8),
                  trajectory=[[0, 0, 0], [1, 0, 0]])
    jm = _populated_reference_map()
    m = convert.map_state(jax.tree_util.tree_map(np.asarray, jm), "cpu")
    assert int(m.kf_valid.sum()) == 3
    np.testing.assert_array_equal(m.covisibility_matrix().numpy(),
                                  np.asarray(jm.covisibility_matrix()))
    tviz.plot_map(str(tmp_path / "map2.png"), m, trajectory=torch.zeros(4, 3), covis_th=4)
    for name in ("map.png", "map2.png"):
        assert (tmp_path / name).stat().st_size > 1000, name


def test_save_frame_png_with_and_without_matplotlib(tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    rgb = tviz.draw_tracked_frame(*_frame())
    tviz.save_frame_png(str(tmp_path / "f.png"), torch.from_numpy(rgb))
    assert (tmp_path / "f.png").read_bytes()[:4] == b"\x89PNG"
    monkeypatch.setitem(sys.modules, "matplotlib", None)       # import raises ImportError
    tviz.save_frame_png(str(tmp_path / "g.png"), rgb)
    data = (tmp_path / "g.png.ppm").read_bytes()
    assert data.startswith(b"P6\n64 48\n255\n") and data.endswith(rgb.tobytes())
