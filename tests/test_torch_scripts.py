"""The port's scripts at a tiny size on the CPU.

`scripts/train_vocab_torch.py` writes a codebook and idf of the asked
size into a temporary directory only (its default output is the shipped
vocabulary, which tests/test_torch_nojax.py holds equal to the
reference's). `scripts/profile_trace_torch.py --device cpu --frames 3`
profiles the mono step at 64x80 and reports its `step.*` spans with no
device time. `scripts/eval_ate_torch.py` prints the line of the
reference's `scripts/eval_ate.py` on the same files. Each runs as its own
process, as a user runs it.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tests.test_torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, *args], cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


def test_train_vocab_torch_writes_only_where_asked(tmp_path):
    shipped = os.path.join(REPO, "uvipslam_torch", "loop", "vocab_data.npz")
    before = os.stat(shipped).st_mtime_ns
    out = tmp_path / "vocab.npz"
    log = _run([os.path.join(REPO, "scripts", "train_vocab_torch.py"), "--device", "cpu",
                "--seqs", "2", "--frames", "2", "--size", "64", "80", "--words", "16",
                "--iters", "2", "--out", str(out)], tmp_path)
    assert "saved" in log
    data = np.load(out)
    cb, idf = data["codebook"], data["idf"]
    assert cb.shape == (16, 256) and cb.dtype == np.int8 and set(np.unique(cb)) <= {0, 1}
    assert idf.shape == (16,) and idf.dtype == np.float32 and (idf >= 1e-3).all()
    assert os.stat(shipped).st_mtime_ns == before


@pytest.mark.parametrize("vip", [False, True])
def test_profile_trace_torch_on_cpu(tmp_path, vip):
    out = tmp_path / "profile.txt"
    log = _run([os.path.join(REPO, "scripts", "profile_trace_torch.py"), "--device", "cpu",
                "--frames", "3", "--size", "64", "80", "--out", str(out)]
               + (["--vip"] if vip else []), tmp_path)
    assert "no device in a CPU run" in log and "step." in log, log
    assert "device busy" not in log
    assert out.stat().st_size > 0


@pytest.mark.parametrize("align", ["sim3", "se3", "posyaw", "none"])
def test_eval_ate_torch_prints_the_reference_line(tmp_path, align):
    """`scripts/eval_ate_torch.py` and the reference's `scripts/eval_ate.py`
    on the same two trajectory files: the same keys, equal integers and
    strings, floats within 1e-9."""
    from uvipslam_torch.io.evaluate import save_tum_groundtruth

    rs = np.random.RandomState(3)
    ts = np.arange(40) * 0.05
    gt = np.stack([np.linspace(0, 3, 40), 0.4 * np.sin(2 * ts), 0.1 * np.cos(ts)], 1)
    c, s = np.cos(0.3), np.sin(0.3)
    est = 0.7 * gt @ np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]).T + [1.0, -2.0, 0.5]
    est += rs.normal(0, 0.01, est.shape)
    gt_f, est_f = str(tmp_path / "gt.txt"), str(tmp_path / "est.txt")
    save_tum_groundtruth(gt_f, ts, gt)
    save_tum_groundtruth(est_f, ts[3:] + 0.004, est[3:])
    args = [est_f, gt_f, "--align", align, "--max-dt", "0.01"]
    port = json.loads(_run([os.path.join(REPO, "scripts", "eval_ate_torch.py"), *args],
                           tmp_path).strip().splitlines()[-1])
    ref = json.loads(_run([os.path.join(REPO, "scripts", "eval_ate.py"), *args],
                          tmp_path).strip().splitlines()[-1])
    assert port.keys() == ref.keys() and ref["n_matched"] == 37
    for k, v in ref.items():
        if isinstance(v, float):
            assert abs(port[k] - v) <= 1e-9, (k, port[k], v)
        else:
            assert port[k] == v, k
