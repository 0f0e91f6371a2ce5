"""The port stands alone and covers the reference: importing every
uvipslam_torch module, chip_smoke.py, bench_torch.py and
scripts/eval_ate_torch.py pulls in neither jax nor the reference
package, every public top-level name of every reference module has its
counterpart in the same module of the port, no module of the port
names a path under the reference package, chip_smoke.py
refuses to run without a card or outside a checkout, and the constants the
port regenerates or carries (BRIEF pattern, vocabulary, haloc projections)
and its synthetic sequences (camera, IMU and pressure) equal the
reference's bit for bit."""

import ast
import hashlib
import os
import pkgutil
import shutil
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
    for m in ("kernels", "convert", "frontend.tracker", "frontend.device_tracker",
              "frontend.device_vip", "frontend.vip_tracker",
              "vio.init", "ops.pnp", "ops.clahe", "solver.global_ba", "loop.reloc",
              "frontend.stream", "loop.closer", "loop.clusters", "loop.dbscan", "ops.sim3solver",
              "solver.essential_graph", "parallel", "parallel.replay", "app", "io.config",
              "io.bag", "io.trajectory", "io.evaluate", "io.checkpoint", "utils.metrics",
              "utils.chiptime", "utils.graphs", "viz", "viz.publishers"):
        assert "uvipslam_torch." + m in mods, m
    code = ("import importlib, importlib.util, sys\n"
            f"for m in {mods + ['chip_smoke', 'bench_torch']!r}: importlib.import_module(m)\n"
            "spec = importlib.util.spec_from_file_location('eval_ate_torch', "
            "'scripts/eval_ate_torch.py')\n"
            "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "assert 'uvipslam_torch.io.evaluate' in sys.modules\n"
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


# reference names with no counterpart in the port, each with its reason
NOT_PORTED = {
    ("utils/cache.py", "enable_persistent_cache"):
        "switches on XLA's persistent compile cache; the port compiles no XLA, and its "
        "kernels are cached by kernels.py's hashed _build/ library",
}


def _top_level_names(path: str, imported: bool) -> set:
    """Public names a module defines at top level (functions, classes,
    assignments), and the names it imports when `imported`."""
    with open(path) as fh:
        body = ast.parse(fh.read()).body
    names = set()
    for n in body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(n.name)
        elif isinstance(n, ast.Assign):
            names.update(t.id for t in n.targets if isinstance(t, ast.Name))
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            names.add(n.target.id)
        elif imported and isinstance(n, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in n.names)
    return {x for x in names if not x.startswith("_")}


def test_port_covers_every_public_name_of_the_reference():
    """Walks both packages' sources with ast (the reference is not
    imported): each reference module has a port module at the same path,
    and each public top-level name of it is a name of that port module,
    defined there or imported into it, apart from NOT_PORTED."""
    ref_root = os.path.join(REPO, "uvipslam_tpu")
    port_root = os.path.join(REPO, "uvipslam_torch")
    missing = []
    for d, _, files in os.walk(ref_root):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(d, f), ref_root)
            want = _top_level_names(os.path.join(ref_root, rel), imported=False)
            port = os.path.join(port_root, rel)
            have = _top_level_names(port, imported=True) if os.path.exists(port) else None
            if have is None and not {(rel, n) for n in want} <= set(NOT_PORTED):
                missing.append((rel, "module"))
                continue
            missing += [(rel, n) for n in sorted(want - (have or set()))
                        if (rel, n) not in NOT_PORTED]
    assert not missing, missing


def _string_constants(tree):
    """Every string constant of a module except its docstrings."""
    docs = set()
    for n in ast.walk(tree):
        if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = n.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                docs.add(id(body[0].value))
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs]


def test_no_module_names_a_reference_path():
    """No string in the port's code (docstrings aside, which cite the
    reference's files) names the reference package, so no module can read
    a file under it."""
    root = os.path.join(REPO, "uvipslam_torch")
    found = []
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(d, f)) as fh:
                    tree = ast.parse(fh.read())
                found += [(f, c) for c in _string_constants(tree) if "uvipslam_tpu" in c]
    assert not found, found


def test_vocabulary_copy_equals_reference():
    def sha(path):
        with open(os.path.join(REPO, path), "rb") as fh:
            return hashlib.sha256(fh.read()).hexdigest()

    assert sha("uvipslam_torch/loop/vocab_data.npz") == sha("uvipslam_tpu/loop/vocab_data.npz")


def test_chip_smoke_imports_no_reference():
    """No import statement of chip_smoke.py names jax or the reference."""
    with open(os.path.join(REPO, "chip_smoke.py")) as fh:
        tree = ast.parse(fh.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert "uvipslam_torch.frontend.device_vip" in names
    assert not [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "uvipslam_tpu")], names


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_card_or_checkout(where, tmp_path):
    """Without a CUDA device (here), or in a directory that holds
    chip_smoke.py and nothing else of the repo, the script exits non-zero
    and prints no result."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, script], cwd=cwd, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


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

    kw = dict(n_frames=4, H=48, W=64, n_points=300, seed=5, motion=motion, speed=1.2,
              gyr_noise=0.005, acc_noise=0.05, gyr_bias=(0.004, -0.006, 0.003),
              depth_noise=0.02, z_amp=0.5)
    j = jsyn.make_sequence(**kw)
    t = tsyn.make_sequence(**kw)
    for f in ("images", "timestamps", "R_cw", "t_cw", "K", "points", "positions_w", "imu_omg",
              "imu_acc", "imu_dt", "imu_mask", "depth", "depth_valid", "gravity_w"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
    assert t.images.dtype == j.images.dtype
    est = j.positions_w + np.random.RandomState(0).normal(0, 0.01, j.positions_w.shape)
    for scale in (True, False):
        a_t, al_t = tsyn.ate_rmse(est, j.positions_w, scale)
        a_j, al_j = jsyn.ate_rmse(est, j.positions_w, scale)
        assert a_t == a_j
        np.testing.assert_array_equal(al_t, al_j)
