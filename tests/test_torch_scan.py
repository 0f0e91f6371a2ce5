"""`Segments.scan` (`uvipslam_torch.utils.graphs`), the port's counterpart
of the reference's `lax.scan`, in its plain CPU form, and the loops that
take it: each of the port's loops run through a graphed `Segments` on the
CPU (a capture per key and carry layout, its function replayed on the
static buffers) against its plain loop, bit for bit, on small inputs
made from a seed, and `Segments.lifted_scan` (the fleets' VIO init's
loops) over two streams. The card's captures are held in
tests/test_torch_cuda.py; the VIP step through its pre-VIO keyframe and
VIO init, and the fleet's VIO init, in tests/test_torch_vip.py. About
12 s on one thread.
"""

import dataclasses

import numpy as np
import pytest
import torch

from uvipslam_torch.core import lie
from uvipslam_torch.core.preintegration import PreintState, preintegrate
from uvipslam_torch.core.tree import over_streams, tree_leaves
from uvipslam_torch.solver.essential_graph import optimize_essential_graph
from uvipslam_torch.solver.local_ba import local_ba_se3
from uvipslam_torch.utils.graphs import SegmentError, Segments, plain_scan
from uvipslam_torch.vio.init import estimate_gyro_bias
from tests.test_torch_threads import one_torch_thread  # noqa: F401

FX, FY, CX, CY = 100.0, 100.0, 80.0, 60.0


def _bits(tree):
    return torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8)
                      for t in tree_leaves(tree)])


def _rotations(rng, n, scale):
    return lie.so3_exp(torch.from_numpy(rng.normal(scale=scale, size=(n, 3)).astype(np.float32)))


def _f32(rng, *shape, scale=1.0):
    return torch.from_numpy(rng.normal(scale=scale, size=shape).astype(np.float32))


@dataclasses.dataclass
class _Run:
    """One loop's call on fixed arguments: run(scan) calls it with `scan`."""
    fn: object
    args: tuple
    kw: dict

    def __call__(self, scan):
        return self.fn(*self.args, **self.kw, scan=scan)


def _preint_case(seed):
    """Three windows of 20 samples, some masked (dt 0 where masked)."""
    rng = np.random.default_rng(seed)
    K, T = 3, 20
    mask = torch.from_numpy((rng.random((K, T)) > 0.25).astype(np.float32))
    dts = torch.full((K, T), 0.005) * (1.0 + 0.1 * _f32(rng, K, T))
    args = (_f32(rng, K, T, 3, scale=0.3), _f32(rng, K, T, 3) + torch.tensor([0.0, 0.0, 9.81]),
            dts, mask, _f32(rng, K, 3, scale=0.01), _f32(rng, K, 3, scale=0.05))
    return _Run(preintegrate, args + (0.01, 0.1), {}), T


def _ba_case(seed, W=4, P=64, F=48):
    """A window of W keyframes looking at P points, F observations each
    (the grid layout), some masked, poses and points perturbed."""
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.uniform([-1.0, -1.0, 4.0], [1.0, 1.0, 6.0],
                                       (P, 3)).astype(np.float32))
    R = _rotations(rng, W, 0.05)
    t = torch.stack([torch.tensor([-0.3 * k, 0.05 * k, 0.0]) for k in range(W)])
    obs_pt = torch.from_numpy(np.stack([rng.permutation(P)[:F] for _ in range(W)]))
    pc = torch.einsum("kij,kfj->kfi", R, pts[obs_pt]) + t[:, None]
    uv = torch.stack([FX * pc[..., 0] / pc[..., 2] + CX, FY * pc[..., 1] / pc[..., 2] + CY], -1)
    uv = uv + _f32(rng, W, F, 2, scale=0.5)
    obs_mask = torch.from_numpy(rng.random((W, F)) > 0.1)
    R0 = lie.so3_exp(_f32(rng, W, 3, scale=0.01)) @ R
    args = (R0, t + _f32(rng, W, 3, scale=0.02), torch.arange(W) == 0,
            torch.ones(W, dtype=torch.bool), pts + _f32(rng, P, 3, scale=0.02),
            torch.ones(P, dtype=torch.bool), torch.arange(W)[:, None].expand(W, F), obs_pt, uv,
            torch.ones(W, F), obs_mask, FX, FY, CX, CY)
    return _Run(local_ba_se3, args, dict(n_iters=3, rounds=2, p_active=P)), 6


def _gyro_case(seed, K=6):
    rng = np.random.default_rng(seed)
    R_wb = _rotations(rng, K, 0.5)
    dR = R_wb.transpose(-1, -2) @ torch.roll(R_wb, -1, 0)
    args = (R_wb, torch.roll(dR, 1, 0) @ _rotations(rng, K, 0.01), _f32(rng, K, 3, 3, scale=0.1),
            torch.from_numpy(np.arange(K) > 0))
    return _Run(estimate_gyro_bias, args, {}), 5


def _eg_case(seed, K=6, E=8):
    rng = np.random.default_rng(seed)
    args = (1.0 + 0.05 * _f32(rng, K), _rotations(rng, K, 0.3), _f32(rng, K, 3),
            torch.ones(K, dtype=torch.bool), torch.arange(K) == 0,
            torch.from_numpy(rng.integers(0, K, E)), torch.from_numpy(rng.integers(0, K, E)),
            1.0 + 0.05 * _f32(rng, E), _rotations(rng, E, 0.3), _f32(rng, E, 3),
            torch.from_numpy(rng.random(E) > 0.2))
    return _Run(optimize_essential_graph, args, dict(n_iters=4)), 4


CASES = {"preintegrate": _preint_case, "local_ba_se3": _ba_case,
         "estimate_gyro_bias": _gyro_case, "essential_graph": _eg_case}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_form_equals_the_plain_loop(name):
    """Each loop through a graphed Segments' plain form gives its plain
    loop's result bit for bit, one scan step per iteration."""
    run, steps = CASES[name](0)
    seg = Segments("cpu")
    assert torch.equal(_bits(run(seg.scan)), _bits(run(None)))
    assert seg.scan_steps == steps and seg.captures >= 1 and seg.replays == 0
    assert all(k[0] == "scan" for k in seg.keys)


@pytest.mark.parametrize("name", list(CASES))
def test_two_calls_with_other_constants_each_equal_their_own_plain_run(name):
    """The closure trap: a second call of a key with other tensors (the
    same shapes) replays the first call's graphs on its own constants and
    gives its own plain loop's result, capturing nothing new."""
    seg = Segments("cpu")
    (run0, _), (run1, steps) = CASES[name](0), CASES[name](1)
    assert torch.equal(_bits(run0(seg.scan)), _bits(run0(None)))
    captures = seg.captures
    out1 = run1(seg.scan)
    assert torch.equal(_bits(out1), _bits(run1(None)))
    assert not torch.equal(_bits(out1), _bits(run0(None)))
    assert seg.captures == captures and seg.scan_steps == 2 * steps


def test_a_body_closing_over_a_tensor_replays_the_first_calls():
    """Why a body may close over Python values only: one that closes over
    a tensor keeps the first call's in its graph (in the CPU's plain form
    the first call's function; on the card freed memory)."""
    seg = Segments("cpu")
    x = torch.ones(3)
    for k in (2.0, 3.0):
        t = torch.full((3,), k)
        y = seg.scan(("closes",), lambda c, _, t=t: c * t, x, length=2)
        assert torch.equal(y, torch.full((3,), 4.0))           # 2 * 2, both times
        z = seg.scan(("consts",), lambda c, _, t: c * t, x, length=2, consts=(t,))
        assert torch.equal(z, torch.full((3,), k * k))


def test_a_generator_in_the_carry_raises():
    seg = Segments("cpu")
    with pytest.raises(SegmentError, match="'gen'"):
        seg.scan(("gen",), lambda c, _: c, (torch.ones(2), torch.Generator()), length=2)
    assert seg.scan_steps == 0 and not seg.graphs


def test_scan_inside_a_segment_runs_the_plain_loop():
    """Graphs never nest: a scan inside a segment's function runs the
    plain loop, which the segment's capture records."""
    seg = Segments("cpu")
    run, steps = _gyro_case(0)
    out = seg.run(("outer",), lambda: run(seg.scan))
    assert torch.equal(_bits(out), _bits(run(None)))
    assert seg.keys == {("outer",)} and seg.scan_steps == 0
    assert torch.equal(_bits(seg.run(("outer",), lambda: run(seg.scan))), _bits(out))


def test_graphs_off_and_xs_with_ys():
    """`graphs=False` runs the plain loop; `xs` is scanned along its first
    dimension and `ys` stacks the per-step outputs, as `lax.scan`."""
    xs = (torch.arange(12.0).reshape(4, 3), torch.arange(4))

    def body(c, x):
        v, i = x
        c = c * 0.5 + v
        return c, (c.sum(), i * 2)

    want = plain_scan(None, body, torch.zeros(3), xs, ys=True)
    for seg in (Segments("cpu", graphs=False), Segments("cpu")):
        got = seg.scan(("ys",), body, torch.zeros(3), xs, ys=True)
        assert torch.equal(_bits(got), _bits(want))
        assert seg.scan_steps == (4 if seg.enabled else 0)
    assert want[1][0].shape == (4,) and torch.equal(want[1][1], torch.arange(4) * 2)


def test_a_carry_whose_layout_the_body_changes_takes_a_second_graph():
    """The plain loop's first step sees the caller's layout, the later
    steps the body's: a transposed initial carry gives one graph for the
    first step and one for the rest, each replayed on its layout."""
    seg = Segments("cpu")
    m0 = torch.arange(9.0).reshape(3, 3).T / 10.0
    body = lambda c, _, a: a @ c + c            # noqa: E731
    a = torch.eye(3) * 0.5
    out = seg.scan(("mm",), body, m0, length=4, consts=(a,))
    assert torch.equal(out, plain_scan(None, body, m0, length=4, consts=(a,)))
    assert seg.graphs_per_key() == {("scan", "mm"): 2}
    assert torch.equal(seg.scan(("mm",), body, m0, length=4, consts=(a,)), out)
    assert seg.captures == 2


def test_preintegration_of_a_step_minor_window_takes_one_graph():
    """Trap 2: a window's sample k of [K, T, 3] sits at a byte offset that
    cycles through four 16-byte alignments; the scan's step-major copy
    gives every step one layout, one graph, and the plain loop's bits."""
    run, steps = _preint_case(2)
    seg = Segments("cpu")
    out = run(seg.scan)
    assert isinstance(out, PreintState) and torch.equal(_bits(out), _bits(run(None)))
    assert list(seg.graphs_per_key().values()) == [1] and seg.scan_steps == steps


# per-stream agreement of the lifted loops with each stream's own plain
# loop: bit for bit, except where the batched products of the vmapped
# body round otherwise than the single stream's (the essential graph's
# Sim3 solve: 1.9e-6 here)
STREAM_ATOL = {"essential_graph": 1e-5}


def _two_streams(name):
    """Case `name` at seeds 0 and 1 as a fleet of two streams: (run(scan)
    over the stream axis, the two single-stream runs, the steps)."""
    (r0, steps), (r1, _) = CASES[name](0), CASES[name](1)
    args = tuple(torch.stack([a, b]) if isinstance(a, torch.Tensor) else a
                 for a, b in zip(r0.args, r1.args))
    return (lambda scan: over_streams(lambda *a: r0.fn(*a, **r0.kw, scan=scan), *args)), \
        (r0, r1), steps


@pytest.mark.parametrize("name", list(CASES))
def test_lifted_scan_over_two_streams(name):
    """`Segments.lifted_scan` under `over_streams`, as the fleets' VIO init
    runs its loops: graphed (the plain form of one capture per key, group
    size and carry layout, replayed once per iteration for both streams)
    equals `graphs=False` (the plain loop of the vmapped body) bit for
    bit, and both equal the old form (the plain loop run under the vmap)
    bit for bit; each stream agrees with its own plain loop within
    STREAM_ATOL. Outside a vmap the lifted scan is the plain loop."""
    run, singles, steps = _two_streams(name)
    seg, eager = Segments("cpu"), Segments("cpu", graphs=False)
    got = run(seg.lifted_scan)
    assert torch.equal(_bits(got), _bits(run(eager.lifted_scan)))
    assert torch.equal(_bits(got), _bits(run(None)))
    assert seg.scan_steps == steps and eager.scan_steps == 0
    assert seg.keys and all(k[0] == "scan" and k[-1] == "streams" for k in seg.keys)
    atol = STREAM_ATOL.get(name, 0.0)
    for i, single in enumerate(singles):
        for a, b in zip(tree_leaves(got), tree_leaves(single(None)), strict=True):
            torch.testing.assert_close(a[i], b, atol=atol, rtol=0)
    one = Segments("cpu")
    assert torch.equal(_bits(singles[0](one.lifted_scan)), _bits(singles[0](None)))
    assert one.scan_steps == 0 and not one.graphs
