"""Nothing the benchmark runs imports jax or the JAX package, and the
plain reference imports nothing of the program either: each module's
top-level name (before the first dot) compared whole, statically over
the sources and in a fresh process over what importing them loads."""

import ast
import glob
import os
import subprocess
import sys

from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "uvipslam_tpu"}
REFERENCE = ["reference.py", "tail.py", "references/vip.py", "references/mono.py"]


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def harness_files():
    return [p for p in glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True)
            if os.sep + "tests" + os.sep not in p]


def test_no_source_imports_jax():
    for p in harness_files():
        assert not top_level_imports(p) & FORBIDDEN, p


def test_reference_imports_nothing_of_the_program():
    for rel in REFERENCE:
        names = top_level_imports(os.path.join(BENCH, rel))
        assert not names & (FORBIDDEN | {"uvipslam_torch"}), rel


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH, capture_output=True,
                         text=True, check=True, env={**os.environ, "PYTHONPATH": BENCH})
    return set(out.stdout.split())


def test_what_the_harness_loads():
    code = ("import sys; sys.path.insert(0, '..'); import run, dives, devtrace, roofline, "
            "importlib; [importlib.import_module(m) for m in ('entries.vip', 'entries.mono', "
            "'references.vip', 'references.mono')]; "
            "print(' '.join({m.split('.')[0] for m in sys.modules}))")
    loaded = _loaded(code)
    assert "uvipslam_torch" in loaded
    assert not loaded & FORBIDDEN


def test_what_the_reference_loads():
    code = ("import importlib, sys; [importlib.import_module(m) for m in ('reference', 'tail', "
            "'references.vip', 'references.mono')]; "
            "print(' '.join({m.split('.')[0] for m in sys.modules}))")
    assert not _loaded(code) & (FORBIDDEN | {"uvipslam_torch"})
