"""Host-side visualization: the FramePublisher / MapPublisher equivalents.

Counterpart of `uvipslam_tpu/viz/publishers.py`. A frame is annotated
into an RGB numpy image (`draw_tracked_frame`, numpy only) and saved as a
PNG through matplotlib, or as a raw PPM where matplotlib is missing
(`save_frame_png`); the map is drawn top-down with matplotlib
(`plot_map`, which needs it). Inputs may be tensors on any device or
numpy arrays; they are read once to the host. matplotlib is imported only
inside the two functions that draw with it, so the module imports
without it.
"""

from __future__ import annotations

import numpy as np


def _host(x) -> np.ndarray:
    """A tensor (any device) or array-like as a numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def draw_tracked_frame(img, xy, valid, has_point, state_text: str = "") -> np.ndarray:
    """Annotate a grayscale frame [H, W]: a 3x3 stamp per valid feature,
    green where it has a map point and orange where it is a fresh track.
    Returns an RGB uint8 image [H, W, 3]."""
    img, xy, valid, has_point = (_host(a) for a in (img, xy, valid, has_point))
    H, W = img.shape
    rgb = np.clip(np.stack([img, img, img], -1).astype(np.float32), 0, 255)
    for i in range(len(xy)):
        if not valid[i]:
            continue
        xi, yi = int(round(float(xy[i, 0]))), int(round(float(xy[i, 1])))
        if 1 <= xi < W - 1 and 1 <= yi < H - 1:
            rgb[yi - 1:yi + 2, xi - 1:xi + 2] = (0, 255, 0) if has_point[i] else (255, 160, 0)
    return rgb.astype(np.uint8)


def save_frame_png(path: str, rgb) -> None:
    """Write an RGB image as a PNG at `path`; without matplotlib, as a
    binary PPM at `path + ".ppm"`."""
    rgb = _host(rgb)
    try:
        import matplotlib
    except ImportError:
        with open(path + ".ppm", "wb") as f:
            f.write(b"P6\n%d %d\n255\n" % (rgb.shape[1], rgb.shape[0]))
            f.write(np.ascontiguousarray(rgb, dtype=np.uint8).tobytes())
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    plt.imsave(path, rgb)


def plot_map(path: str, m, trajectory=None, covis_th: int = 30,
             frustum_scale: float = 0.15) -> None:
    """Top-down figure of a `MapState` at `path`: landmarks, keyframes,
    covisibility edges of at least `covis_th` shared points, the spanning
    tree (`kf_prev`), the newest keyframe's camera frustum and an optional
    trajectory [T, 3]."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from uvipslam_torch.core.tree import tree_map
    from uvipslam_torch.frontend.tracker import _ns_to_cam_pose

    pts, ptv = _host(m.pt_xyz), _host(m.pt_valid)
    kfp, kfv = _host(m.kf_ns.p), _host(m.kf_valid)

    fig, ax = plt.subplots(figsize=(8, 6))
    if ptv.any():
        ax.scatter(pts[ptv, 0], pts[ptv, 1], s=1, c="gray", label="landmarks")

    if kfv.sum() >= 2:
        W = _host(m.covisibility_matrix())
        ii, jj = np.nonzero(np.triu(W, 1) >= covis_th)
        for a, b in zip(ii, jj):
            if kfv[a] and kfv[b]:
                ax.plot([kfp[a, 0], kfp[b, 0]], [kfp[a, 1], kfp[b, 1]],
                        c="limegreen", lw=0.4, alpha=0.5, zorder=1)
        prev = _host(m.kf_prev)
        for k in np.nonzero(kfv)[0]:
            p = prev[k]
            if p >= 0 and kfv[p]:
                ax.plot([kfp[k, 0], kfp[p, 0]], [kfp[k, 1], kfp[p, 1]],
                        c="navy", lw=0.7, zorder=2)

    if kfv.any():
        ax.plot(kfp[kfv, 0], kfp[kfv, 1], "b^", ms=4, label="keyframes")
        # the current camera at the newest keyframe: a wedge along the
        # optical axis
        k_last = int(np.nonzero(kfv)[0].max())
        Rcw, tcw = _ns_to_cam_pose(tree_map(lambda x: x[k_last], m.kf_ns))
        Rcw, tcw = _host(Rcw).astype(np.float64), _host(tcw).astype(np.float64)
        C = -Rcw.T @ tcw
        z = Rcw.T @ np.asarray([0.0, 0.0, 1.0])
        x = Rcw.T @ np.asarray([1.0, 0.0, 0.0])
        f = frustum_scale
        corners = [C + f * (2 * z + x), C + f * (2 * z - x)]
        for c in corners:
            ax.plot([C[0], c[0]], [C[1], c[1]], c="red", lw=1.2, zorder=3)
        ax.plot([corners[0][0], corners[1][0]], [corners[0][1], corners[1][1]],
                c="red", lw=1.2, zorder=3)

    if trajectory is not None and len(trajectory):
        traj = _host(trajectory)
        ax.plot(traj[:, 0], traj[:, 1], "g-", lw=1.0, label="trajectory")
    ax.set_aspect("equal")
    ax.legend(loc="best", fontsize=8)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
