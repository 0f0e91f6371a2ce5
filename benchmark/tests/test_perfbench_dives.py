"""The dives: made from the seed alone, and the program's synthetic
sequence painted again."""

import numpy as np
import pytest
import torch

import dives

SEQ = dict(H=64, W=80, n_points=300, sprite=9, speed=1.2, z_amp=0.5, motion="arc", fps=20.0,
           imu_rate=200.0, gyr_noise=0.005, acc_noise=0.05, gyr_bias=[0.004, -0.006, 0.003],
           acc_bias=[0.03, -0.02, 0.04], depth_noise=0.02)


def _same(a, b):
    return (torch.equal(a.images, b.images) and all(
        np.array_equal(getattr(a, k), getattr(b, k))
        for k in ("imu_omg", "imu_acc", "imu_dt", "imu_mask", "depth", "R_cw", "t_cw")))


def test_the_traffic_fixes_the_dives():
    a = dives.make_dives(SEQ, [7, 8], 6, "cpu")
    b = dives.make_dives(SEQ, [7, 8], 6, "cpu")
    assert all(_same(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0].images, a[1].images)      # two scenes
    assert not np.array_equal(a[0].imu_acc, a[1].imu_acc)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 12345, 2 ** 40 + 3, -5])
def test_same_seed_same_order_and_judged_frames(seed):
    """A run's seed, any whole number, gives its order of the dives and
    its judged frames, the same each time."""
    import run

    assert run.dive_ids(3, 8, 8, dives.derive_seed(seed, 5) % 8) == \
        run.dive_ids(3, 8, 8, dives.derive_seed(seed, 5) % 8)
    assert dives.derive_seed(seed, 4, 2) == dives.derive_seed(seed, 4, 2) < 2 ** 32
    assert dives.derive_seed(seed, 4, 2) != dives.derive_seed(seed + 1, 4, 2)


def test_a_dive_is_the_program_sequence_of_its_scene_seed():
    """A dive equals the program's `make_sequence(seed=s)` at the same
    settings: the images to float32 rounding, the rest exactly."""
    from uvipslam_torch.io.synthetic import make_sequence

    T = 5
    seq = dict(SEQ, n_points=400)
    (d,) = dives.make_dives(seq, [7], T, "cpu")
    ref = make_sequence(n_frames=T, H=SEQ["H"], W=SEQ["W"], n_points=400, seed=7, speed=1.2,
                        gyr_noise=0.005, acc_noise=0.05, gyr_bias=(0.004, -0.006, 0.003),
                        acc_bias=(0.03, -0.02, 0.04), depth_noise=0.02, z_amp=0.5)
    np.testing.assert_allclose(d.images.numpy(), ref.images, atol=1e-3)
    np.testing.assert_allclose(d.R_cw, ref.R_cw, atol=1e-12)
    np.testing.assert_allclose(d.t_cw, ref.t_cw, atol=1e-12)
    np.testing.assert_allclose(d.imu_omg, ref.imu_omg, atol=1e-6)
    np.testing.assert_allclose(d.imu_acc, ref.imu_acc, atol=1e-5)
    np.testing.assert_array_equal(d.imu_dt, ref.imu_dt)
    np.testing.assert_array_equal(d.imu_mask, ref.imu_mask)
    np.testing.assert_allclose(d.depth, ref.depth, atol=1e-6)
    np.testing.assert_allclose(d.timestamps, ref.timestamps, atol=1e-12)


def test_dive_order_rotates_scenes():
    import run

    for k in range(5):
        ids = run.dive_ids(k, 8, 8, 3)
        assert sorted(ids) == list(range(8))                      # each stream its own
        nxt = run.dive_ids(k + 1, 8, 8, 3)
        assert all(a != b for a, b in zip(ids, nxt))              # consecutive dives differ
    assert [run.dive_ids(k, 1, 2, 0)[0] for k in range(4)] == [0, 1, 0, 1]
