"""3D visualization (port of detzero_tpu/utils/visualize.py; reference
utils/detzero_utils/visualize_utils + daemon/visualizer.py): point-cloud +
box playback through open3d, and a headless matplotlib BEV render.  Both
are imported inside the functions that draw, so importing this module
needs neither (a headless GPU host may have neither)."""

from __future__ import annotations

import numpy as np

from detzero_tpu_torch.ops import box_np

CLASS_COLORS = {
    "Vehicle": (0.0, 0.8, 0.2), "Pedestrian": (0.9, 0.3, 0.1),
    "Cyclist": (0.2, 0.4, 1.0), "gt": (1.0, 1.0, 1.0),
}


def _require_open3d():
    try:
        import open3d as o3d  # noqa: F401
        return o3d
    except ImportError as e:
        raise ImportError("open3d is not installed; use plot_bev() for the "
                          "matplotlib fallback") from e


def boxes_to_lineset(boxes, color=(0, 1, 0)):
    """(N, 7) -> open3d LineSet of wireframe boxes."""
    o3d = _require_open3d()
    corners = []
    for b in np.asarray(boxes, float).reshape(-1, 7):
        c = box_np.boxes_to_corners_bev(b[None, [0, 1, 3, 4, 6]])[0]
        z0, z1 = b[2] - b[5] / 2, b[2] + b[5] / 2
        corners.append(np.concatenate([
            np.concatenate([c, np.full((4, 1), z0)], 1),
            np.concatenate([c, np.full((4, 1), z1)], 1),
        ]))
    lines = [[0, 1], [1, 2], [2, 3], [3, 0], [4, 5], [5, 6], [6, 7], [7, 4],
             [0, 4], [1, 5], [2, 6], [3, 7]]
    geoms = []
    for pts in corners:
        ls = o3d.geometry.LineSet(
            o3d.utility.Vector3dVector(pts),
            o3d.utility.Vector2iVector(lines))
        ls.colors = o3d.utility.Vector3dVector([color] * len(lines))
        geoms.append(ls)
    return geoms


def visualize_frame(points, pred_boxes=None, gt_boxes=None, names=None):
    """Interactive open3d window: one frame of points + boxes."""
    o3d = _require_open3d()
    pc = o3d.geometry.PointCloud(
        o3d.utility.Vector3dVector(np.asarray(points)[:, :3]))
    geoms = [pc]
    if pred_boxes is not None:
        for i, b in enumerate(np.asarray(pred_boxes).reshape(-1, 7)):
            color = CLASS_COLORS.get(
                names[i] if names is not None else "Vehicle", (0, 1, 0))
            geoms += boxes_to_lineset(b[None], color)
    if gt_boxes is not None:
        geoms += boxes_to_lineset(gt_boxes, CLASS_COLORS["gt"])
    o3d.visualization.draw_geometries(geoms)


def plot_bev(points, pred_boxes=None, gt_boxes=None, names=None,
             out_path=None, extent=80.0):
    """Headless BEV render to png (matplotlib)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 10), facecolor="black")
    ax.set_facecolor("black")
    pts = np.asarray(points)
    ax.scatter(pts[:, 0], pts[:, 1], s=0.05, c="#8899aa", linewidths=0)

    def draw(boxes, color):
        for b in np.asarray(boxes, float).reshape(-1, 7):
            c = box_np.boxes_to_corners_bev(b[None, [0, 1, 3, 4, 6]])[0]
            ax.plot(np.append(c[:, 0], c[0, 0]), np.append(c[:, 1], c[0, 1]),
                    color=color, linewidth=0.8)

    if gt_boxes is not None:
        draw(gt_boxes, "white")
    if pred_boxes is not None:
        pb = np.asarray(pred_boxes).reshape(-1, 7)
        for i, b in enumerate(pb):
            cls = names[i] if names is not None else "Vehicle"
            draw(b[None], CLASS_COLORS.get(str(cls), (0, 1, 0)))
    ax.set_xlim(-extent, extent)
    ax.set_ylim(-extent, extent)
    ax.set_aspect("equal")
    ax.axis("off")
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight",
                    facecolor="black")
        plt.close(fig)
        return out_path
    return fig


def sequence_playback(frames, out_dir, stride: int = 1):
    """Render every (stride-th) frame of a sequence to BEV pngs
    (daemon/visualizer.py sequence_visualize3d, headless)."""
    from pathlib import Path
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    paths = []
    for i, fr in enumerate(frames[::stride]):
        p = out / f"frame_{i:04d}.png"
        plot_bev(fr.get("points", np.zeros((0, 3))),
                 pred_boxes=fr.get("boxes"), gt_boxes=fr.get("gt_boxes"),
                 names=fr.get("names"), out_path=p)
        paths.append(p)
    return paths
