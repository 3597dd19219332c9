"""Scene renders of the demo (counterpart of the JAX package's
`tools/visual_utils/visualize_utils.py`): a matplotlib 3D wireframe render
and a BEV plot of a cloud with its boxes, saved as PNG.

matplotlib is imported only when a render is asked for. Where it is not
installed, `draw_scenes` raises an ImportError that names it and the
demo's `--vis none`.
"""
from __future__ import annotations

import numpy as np


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError('the scene render needs matplotlib, which is not installed: '
                          'install it, or pass --vis none to print and save the boxes '
                          'without a render') from e
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt


def box_corners_bev(boxes) -> np.ndarray:
    """(N, 7) -> (N, 4, 2) BEV corners."""
    boxes = np.asarray(boxes, np.float32)
    c, s = np.cos(boxes[:, 6]), np.sin(boxes[:, 6])
    local = np.array([[1, 1], [-1, 1], [-1, -1], [1, -1]], np.float32) / 2.0
    lx = local[None, :, 0] * boxes[:, None, 3]
    ly = local[None, :, 1] * boxes[:, None, 4]
    x = lx * c[:, None] - ly * s[:, None] + boxes[:, None, 0]
    y = lx * s[:, None] + ly * c[:, None] + boxes[:, None, 1]
    return np.stack([x, y], axis=-1)


def box_corners_3d(boxes) -> np.ndarray:
    """(N, 7) -> (N, 8, 3) cuboid corners (bottom 0, 1, 2, 7; top 6, 3, 4, 5;
    +x is the heading before the rotation)."""
    boxes = np.asarray(boxes, np.float32)
    tmpl = np.array([[1, -1, -1], [1, 1, -1], [-1, -1, -1], [1, 1, 1],
                     [-1, -1, 1], [-1, 1, 1], [1, -1, 1], [-1, 1, -1]], np.float32) / 2.0
    local = tmpl[None] * boxes[:, None, 3:6]
    c, s = np.cos(boxes[:, 6]), np.sin(boxes[:, 6])
    x = local[..., 0] * c[:, None] - local[..., 1] * s[:, None]
    y = local[..., 0] * s[:, None] + local[..., 1] * c[:, None]
    return np.stack([x, y, local[..., 2]], -1) + boxes[:, None, :3]


# the wireframe's edges and the two crossed diagonals that mark the heading face
BOX_EDGES = [(0, 1), (1, 7), (7, 2), (2, 0), (6, 3), (3, 5), (5, 4),
             (4, 6), (0, 6), (1, 3), (2, 4), (7, 5), (0, 3), (1, 6)]


def draw_scenes_bev(points, gt_boxes=None, ref_boxes=None, ref_scores=None,
                    save_path='scene_bev.png', title=None) -> str:
    """BEV scatter of the points with the boxes' outlines (ground truth
    green, detections red with their scores). Returns `save_path`."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(12, 14))
    pts = np.asarray(points)
    ax.scatter(pts[:, 0], pts[:, 1], s=0.2, c=pts[:, 2], cmap='viridis')
    for boxes, color, scores in ((gt_boxes, 'limegreen', None), (ref_boxes, 'red', ref_scores)):
        if boxes is None or not len(boxes):
            continue
        for i, c4 in enumerate(box_corners_bev(boxes)):
            poly = np.vstack([c4, c4[:1]])
            ax.plot(poly[:, 0], poly[:, 1], color=color, linewidth=1.2)
            if scores is not None:
                ax.text(c4[0, 0], c4[0, 1], f'{float(scores[i]):.2f}', fontsize=6, color=color)
    ax.set_aspect('equal')
    ax.set_xlabel('x [m]')
    ax.set_ylabel('y [m]')
    if title:
        ax.set_title(title)
    fig.savefig(save_path, dpi=120, bbox_inches='tight')
    plt.close(fig)
    return save_path


def draw_scenes_3d(points, gt_boxes=None, ref_boxes=None, ref_scores=None,
                   save_path='scene_3d.png', title=None, max_points=60000, elev=25,
                   azim=-60) -> str:
    """3D render of the points (at most `max_points`, evenly taken) and the
    boxes' wireframes. Returns `save_path`."""
    plt = _pyplot()
    from mpl_toolkits.mplot3d.art3d import Line3DCollection

    pts = np.asarray(points)[:, :3]
    if len(pts) > max_points:
        pts = pts[np.linspace(0, len(pts) - 1, max_points).astype(int)]
    fig = plt.figure(figsize=(14, 10))
    ax = fig.add_subplot(projection='3d', computed_zorder=False)
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=0.15, c=pts[:, 2], cmap='viridis',
               depthshade=False)
    for boxes, color, scores in ((gt_boxes, 'limegreen', None), (ref_boxes, 'red', ref_scores)):
        if boxes is None or not len(boxes):
            continue
        corners = box_corners_3d(boxes)
        segs = [[c8[a], c8[b]] for c8 in corners for a, b in BOX_EDGES]
        ax.add_collection3d(Line3DCollection(segs, colors=color, linewidths=1.2))
        if scores is not None:
            for c8, sc in zip(corners, scores):
                ax.text(c8[3, 0], c8[3, 1], c8[3, 2], f'{float(sc):.2f}', fontsize=6,
                        color=color)
    lo, hi = pts.min(0), pts.max(0)
    mid, half = (lo + hi) / 2, (hi - lo).max() / 2
    ax.set_xlim(mid[0] - half, mid[0] + half)
    ax.set_ylim(mid[1] - half, mid[1] + half)
    ax.set_zlim(mid[2] - half * 0.4, mid[2] + half * 0.4)
    ax.view_init(elev=elev, azim=azim)
    ax.set_xlabel('x [m]')
    ax.set_ylabel('y [m]')
    if title:
        ax.set_title(title)
    fig.savefig(save_path, dpi=120, bbox_inches='tight')
    plt.close(fig)
    return save_path


def draw_scenes(points, gt_boxes=None, ref_boxes=None, ref_scores=None, save_path=None,
                mode: str = '3d') -> str:
    """The 3D render (`mode` '3d') or the BEV plot ('bev') into `save_path`
    (default scene_<mode>.png). Returns the path written."""
    draw = draw_scenes_bev if mode == 'bev' else draw_scenes_3d
    return draw(points, gt_boxes, ref_boxes, ref_scores,
                save_path=save_path or f'scene_{mode}.png')
