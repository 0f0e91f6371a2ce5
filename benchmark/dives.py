"""The dives a run replays: a fixed set of synthetic Aqualoc-harbor
sequences, one per scene seed of the traffic file.

A frozen copy of the program's synthetic sequence (`make_sequence` of its
`io/synthetic.py`: a field of textured square sprites seen from a camera
on the `arc` path, the IMU samples between frames, the pressure depth),
rearranged so that a run makes its dives in a few large calls:

- a dive is fixed by its scene seed s, as a recorded dive of a dataset
  is: it is `make_sequence(seed=s)` at the configuration's settings, the
  same draws in the same order; the traffic file lists the scene seeds,
  so every run replays the same dives, and a run's `--seed` only orders
  them (`run.py`);
- the images are painted on the card: the painter's algorithm of
  `make_sequence` (far sprites first, each a sub-pixel shifted square
  `sprite` pixels wide) as a depth buffer, the nearest sprite over each
  pixel winning (equal to the host's painting to float32 rounding), then
  the sensor noise of N(0, 1) gray levels drawn on the host;
- the IMU samples (gyro, accelerometer with biases and white noise) and
  the pressure depth come from the camera path by `make_sequence`'s
  formulas, vectorized.

The camera frame is the body frame (the configurations' `Tbc` is the
identity). Nothing here imports the program: the benchmark hands the same
arrays to the program and to its plain reference.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses

import numpy as np
import torch

G_W = np.array([0.0, 0.0, -9.81])


def derive_seed(seed: int, *keys: int) -> int:
    """A 32-bit seed derived from a seed (any whole number, large or
    negative) and further keys."""
    return int(np.random.SeedSequence([int(seed) % 2 ** 64, *keys]).generate_state(1)[0])


def _center_yaw(motion: str, t, t_end: float, speed: float, z_amp: float):
    """Camera centre [..., 3] and yaw at times t (arrays) for `arc`, the
    path of the configurations (`make_sequence`'s formula)."""
    if motion != "arc":
        raise ValueError(f"motion {motion!r}: the generator has the arc path only")
    t = np.asarray(t, np.float64)
    c = np.stack([speed * t, 0.15 * np.sin(0.7 * t), z_amp * np.sin(0.5 * t)], axis=-1)
    return c, 0.12 * np.sin(0.4 * t)


def _yaw_rotation(yaw):
    """Rotations [..., 3, 3] by `yaw` about the camera's y axis."""
    yaw = np.asarray(yaw, np.float64)
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.zeros(yaw.shape + (3, 3))
    R[..., 0, 0] = c
    R[..., 0, 2] = s
    R[..., 1, 1] = 1.0
    R[..., 2, 0] = -s
    R[..., 2, 2] = c
    return R


@dataclasses.dataclass
class Scene:
    """One sprite field: centres [P, 3], size class [P], textures by class."""
    points: np.ndarray
    cls: np.ndarray
    sizes: np.ndarray
    textures: list      # per class: [n_c, s_c, s_c] float32, in point order within the class


def make_scene(scene_seed: int, n_frames: int, fps: float, n_points: int, speed: float,
               sprite: int, rs: np.random.RandomState | None = None) -> Scene:
    """The sprite field of `make_sequence(seed=scene_seed)`: the same
    draws in the same order (from `rs` when given, which the IMU's and the
    depth's noise then continue)."""
    rs = np.random.RandomState(scene_seed) if rs is None else rs
    t_last = (n_frames - 1) / fps
    span_x = speed * t_last + 6.0
    sizes = np.array([sprite, sprite * 2 + 1, sprite * 4 + 1])
    cls = rs.choice(3, n_points, p=[0.6, 0.3, 0.1])
    pts = np.stack([rs.uniform(-3.0, span_x, n_points), rs.uniform(-2.2, 2.2, n_points),
                    rs.uniform(2.5, 7.0, n_points)], axis=-1)

    # each sprite's base grid, lo x lo uniforms in sprite order: one draw
    # for all of them takes the stream's values in the same order
    sz_of = sizes[cls]
    lo_of = np.maximum(3, sz_of // 3)
    flat = rs.uniform(20, 235, int(np.sum(lo_of * lo_of))).astype(np.float32)
    offsets = np.concatenate([[0], np.cumsum(lo_of * lo_of)])
    by_class = []
    for c in range(3):
        sz = int(sizes[c])
        lo = max(3, sz // 3)
        idx = np.flatnonzero(cls == c)
        base = np.stack([flat[offsets[i]:offsets[i + 1]].reshape(lo, lo) for i in idx]) \
            if len(idx) else np.zeros((0, lo, lo), np.float32)
        yi = np.linspace(0, lo - 1, sz)
        xi = np.linspace(0, lo - 1, sz)
        y0 = np.clip(yi.astype(int), 0, lo - 2)
        x0 = np.clip(xi.astype(int), 0, lo - 2)
        wy = (yi - y0)[:, None]
        wx = (xi - x0)[None, :]
        by_class.append(((1 - wy) * (1 - wx) * base[:, y0][:, :, x0]
                         + (1 - wy) * wx * base[:, y0][:, :, x0 + 1]
                         + wy * (1 - wx) * base[:, y0 + 1][:, :, x0]
                         + wy * wx * base[:, y0 + 1][:, :, x0 + 1]).astype(np.float32))
    return Scene(points=pts, cls=cls, sizes=sizes, textures=by_class)


def camera_path(n_frames: int, fps: float, speed: float, z_amp: float, motion: str = "arc"):
    """World-to-camera rotations [T, 3, 3], translations [T, 3] and the
    frame times [T]."""
    ts = np.arange(n_frames) / fps
    t_end = (n_frames - 1) / fps
    c, yaw = _center_yaw(motion, ts, t_end, speed, z_amp)
    R_cw = np.swapaxes(_yaw_rotation(yaw), -1, -2)
    t_cw = -np.einsum("tij,tj->ti", R_cw, c)
    return R_cw, t_cw, ts


def render(scene: Scene, R_cw, t_cw, K, H: int, W: int, device, chunk: int = 8):
    """The clean images [T, H, W] float32 on `device`: background 60, each
    pixel the value of the nearest visible sprite over it (the painter's
    order of `make_sequence`, which paints far sprites first)."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    T = R_cw.shape[0]
    max_s = int(scene.sizes.max())
    pts = torch.as_tensor(scene.points, dtype=torch.float64, device=device)
    Rs = torch.as_tensor(R_cw, dtype=torch.float64, device=device)
    ts = torch.as_tensor(t_cw, dtype=torch.float64, device=device)
    cls = torch.as_tensor(scene.cls, device=device)
    order = [torch.nonzero(cls == c).flatten() for c in range(3)]
    texs = []
    for c in range(3):
        tx = torch.as_tensor(scene.textures[c], device=device)
        texs.append(torch.nn.functional.pad(tx, (1, 1, 1, 1)))     # np.pad(sp, 1)
    out = torch.empty((T, H, W), dtype=torch.float32, device=device)
    for f0 in range(0, T, chunk):
        f1 = min(T, f0 + chunk)
        n = f1 - f0
        pc = torch.einsum("fij,pj->fpi", Rs[f0:f1], pts) + ts[f0:f1, None, :]
        z = pc[..., 2]
        vis = z > 0.5
        zs = torch.where(vis, z, torch.ones_like(z))
        u = fx * pc[..., 0] / zs + cx
        v = fy * pc[..., 1] / zs + cy
        vis &= (u > -max_s) & (u < W + max_s) & (v > -max_s) & (v < H + max_s)
        idx_all, z_all, val_all = [], [], []
        for c in range(3):
            sz = int(scene.sizes[c])
            fi, pi = torch.nonzero(vis[:, order[c]], as_tuple=True)
            if fi.numel() == 0:
                continue
            p = order[c][pi]
            u0 = u[fi, p] - sz // 2
            v0 = v[fi, p] - sz // 2
            iu, iv = torch.floor(u0), torch.floor(v0)
            au = (u0 - iu).to(torch.float32)[:, None, None]
            av = (v0 - iv).to(torch.float32)[:, None, None]
            sp = texs[c][pi]                                 # [m, sz + 2, sz + 2]
            val = (sp[:, 1:-1, 1:-1] * (1 - au) * (1 - av) + sp[:, 1:-1, 0:-2] * au * (1 - av)
                   + sp[:, 0:-2, 1:-1] * (1 - au) * av + sp[:, 0:-2, 0:-2] * au * av)
            d = torch.arange(sz, device=device)
            yy = iv.long()[:, None, None] + d[None, :, None]
            xx = iu.long()[:, None, None] + d[None, None, :]
            inside = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
            flat = (fi[:, None, None] * (H * W) + yy * W + xx)
            idx_all.append(flat[inside])
            z_all.append(z[fi, p][:, None, None].expand(-1, sz, sz)[inside])
            val_all.append(val[inside])
        img = torch.full((n * H * W,), 60.0, dtype=torch.float32, device=device)
        if idx_all:
            idx, zz, val = torch.cat(idx_all), torch.cat(z_all), torch.cat(val_all)
            zbuf = torch.full((n * H * W,), float("inf"), dtype=torch.float64, device=device)
            zbuf.scatter_reduce_(0, idx, zz, reduce="amin")
            win = zz == zbuf[idx]
            img[idx[win]] = val[win]
        out[f0:f1] = img.view(n, H, W)
    return out


def imu_and_depth(n_frames: int, fps: float, imu_rate: float, speed: float, z_amp: float,
                  gyr_bias, acc_bias, gyr_noise: float, acc_noise: float,
                  depth_noise: float, rs: np.random.RandomState, motion: str = "arc"):
    """The IMU windows [T, S, 3] (gyro, accelerometer), their dt and mask
    [T, S] (frame 0 has none) and the pressure depth [T], by
    `make_sequence`'s formulas (body = camera); the white noise drawn from
    `rs` in `make_sequence`'s order (per sample the gyro's three, then the
    accelerometer's, then the depths')."""
    dt_img = 1.0 / fps
    S = max(1, int(round(imu_rate / fps)))
    dt_imu = dt_img / S
    t_end = (n_frames - 1) * dt_img
    f = np.arange(1, n_frames)[:, None]
    s = np.arange(S)[None, :]
    t_a = (f - 1) * dt_img + s * dt_imu
    t_b = t_a + dt_imu
    _, yaw_a = _center_yaw(motion, t_a, t_end, speed, z_amp)
    _, yaw_b = _center_yaw(motion, t_b, t_end, speed, z_amp)
    Rwb = _yaw_rotation(yaw_b)
    w_body = np.zeros(t_a.shape + (3,))
    w_body[..., 1] = (yaw_b - yaw_a) / dt_imu

    def centre(t):
        return _center_yaw(motion, t, t_end, speed, z_amp)[0]

    a_w = (centre(t_b + dt_imu) - 2 * centre(t_b) + centre(t_b - dt_imu)) / dt_imu ** 2
    noise = rs.randn(n_frames - 1, S, 2, 3)
    omg = np.zeros((n_frames, S, 3), np.float32)
    acc = np.zeros((n_frames, S, 3), np.float32)
    omg[1:] = w_body + np.asarray(gyr_bias) + noise[:, :, 0] * gyr_noise
    acc[1:] = (np.einsum("fsji,fsj->fsi", Rwb, a_w - G_W) + np.asarray(acc_bias)
               + noise[:, :, 1] * acc_noise)
    dt = np.zeros((n_frames, S), np.float32)
    mask = np.zeros((n_frames, S), np.float32)
    dt[1:] = dt_imu
    mask[1:] = 1.0
    ts = np.arange(n_frames) * dt_img
    depth = (centre(ts)[:, 2] + rs.randn(n_frames) * depth_noise).astype(np.float32)
    return omg, acc, dt, mask, depth


@dataclasses.dataclass
class Dive:
    """One dive as both sides receive it: the images on the card, the rest
    on the host as the float32 arrays the program is given, and the ground
    truth for the reference."""
    scene_seed: int
    images: torch.Tensor          # [T, H, W] float32, on the card
    timestamps: np.ndarray        # [T]
    imu_omg: np.ndarray           # [T, S, 3] float32
    imu_acc: np.ndarray
    imu_dt: np.ndarray            # [T, S]
    imu_mask: np.ndarray
    depth: np.ndarray             # [T] float32
    depth_valid: np.ndarray       # [T] bool
    R_cw: np.ndarray              # [T, 3, 3] ground truth
    t_cw: np.ndarray
    K: np.ndarray

    @property
    def positions_w(self) -> np.ndarray:
        """Ground-truth camera centres [T, 3]."""
        return -np.einsum("tij,ti->tj", self.R_cw, self.t_cw)


def intrinsics(H: int, W: int) -> np.ndarray:
    fx = fy = 0.65 * W
    return np.array([[fx, 0, W / 2.0], [0, fy, H / 2.0], [0, 0, 1.0]])


def make_dives(seq: dict, scene_seeds, n_frames: int, device) -> list:
    """One dive per scene seed s, `n_frames` long, with the sequence
    settings `seq` (the configuration's `sequence`): the program's
    `make_sequence(seed=s)` with those settings, its images painted on
    `device` and its image noise drawn on the host in its order."""
    H, W = int(seq["H"]), int(seq["W"])
    fps, speed, z_amp = float(seq["fps"]), float(seq["speed"]), float(seq["z_amp"])
    K = intrinsics(H, W)
    R_cw, t_cw, ts = camera_path(n_frames, fps, speed, z_amp, seq["motion"])
    def image_noise(sc):
        rs_img = np.random.RandomState(int(sc))
        return np.stack([rs_img.randn(H, W).astype(np.float32) for _ in range(n_frames)])

    # the image noise of every dive in threads (numpy draws without the
    # interpreter lock) while the scenes are drawn and painted
    with concurrent.futures.ThreadPoolExecutor(max_workers=min(8, len(scene_seeds))) as pool:
        noises = [pool.submit(image_noise, sc) for sc in scene_seeds]
        dives = []
        for sc, noise in zip(scene_seeds, noises):
            rs = np.random.RandomState(int(sc))
            scene = make_scene(int(sc), n_frames, fps, int(seq["n_points"]), speed,
                               int(seq["sprite"]), rs)
            img = render(scene, R_cw, t_cw, K, H, W, device)
            img += torch.from_numpy(noise.result()).to(device)
            omg, acc, dt, mask, depth = imu_and_depth(
                n_frames, fps, float(seq["imu_rate"]), speed, z_amp, seq["gyr_bias"],
                seq["acc_bias"], float(seq["gyr_noise"]), float(seq["acc_noise"]),
                float(seq["depth_noise"]), rs, seq["motion"])
            dives.append(Dive(scene_seed=int(sc), images=img,
                              timestamps=ts.astype(np.float64), imu_omg=omg, imu_acc=acc,
                              imu_dt=dt, imu_mask=mask, depth=depth,
                              depth_valid=np.ones(n_frames, bool), R_cw=R_cw, t_cw=t_cw, K=K))
    return dives
