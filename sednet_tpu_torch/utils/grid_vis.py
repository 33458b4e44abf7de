"""Offscreen grid-of-shapes image rendering (a copy of
`sednet_tpu/utils/grid_vis.py`).

Rebuild of the open3d image-dumping half of reference src/VisUtils.py —
vis_batch_in_grid (:202-243), grid_points_lists_visulation (:475-502),
grid_meshes_lists_visulation (:504-531), the rotated-view image dumps of
save_images_shape_patches_collection (:311-348). The reference drives an
interactive open3d window and screenshots it; this image is headless and
open3d-free, so the renderer here is a small orthographic projector on
matplotlib's Agg canvas:

  * point clouds -> depth-sorted scatter;
  * meshes -> painter's-algorithm PolyCollection with Lambert shading;
  * same normalization/layout math as the reference (per-shape centering,
    scale by ||max-min||, 1.1/1.2 grid spacing, 60deg/45deg view matrix).

Nothing here touches the device; it consumes numpy dumps (the reference's
txt/OBJ vocabulary) and is exercised by gen_vis.py --images. matplotlib is
imported when a function draws, never at import; where it is absent the
call raises ImportError naming it (the card's machine has none).
"""
from __future__ import annotations

import numpy as np


def _euler_rot(ax: float, ay: float, az: float = 0.0) -> np.ndarray:
    """XYZ euler rotation matrix (reference uses transforms3d.euler2mat with
    the same convention, VisUtils.py:322,356)."""
    cx, sx = np.cos(ax), np.sin(ax)
    cy, sy = np.cos(ay), np.sin(ay)
    cz, sz = np.cos(az), np.sin(az)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rx @ ry @ rz


#: the reference's patch-collection view (60deg, 45deg — VisUtils.py:322)
DEFAULT_VIEW = _euler_rot(60 * np.pi / 180, 45 * np.pi / 180)


def _normalize_cloud(p: np.ndarray) -> np.ndarray:
    """Center + scale by ||max-min|| (reference: VisUtils.py:481-487)."""
    p = np.asarray(p, np.float64)
    span = np.linalg.norm(p.max(0) - p.min(0))
    return (p - p.mean(0, keepdims=True)) / max(span, 1e-12)


def _grid_offsets(n: int, cols: int | None, spacing: float) -> np.ndarray:
    """Row-major grid offsets; square-ish when cols is None
    (reference: VisUtils.py:209-210 height=sqrt(B))."""
    if cols is None:
        rows = max(int(np.sqrt(n)), 1)
        cols = int(np.ceil(n / rows))
    off = np.zeros((n, 3))
    for i in range(n):
        off[i, 0] = (i % cols) * spacing
        off[i, 1] = -(i // cols) * spacing
    return off


def _pyplot():
    """matplotlib.pyplot on the Agg backend, or ImportError naming it."""
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError("grid_vis needs matplotlib, which is not "
                          "installed") from exc
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _canvas(width_px: int, extent):
    plt = _pyplot()

    (x0, x1), (y0, y1) = extent
    w = max(x1 - x0, 1e-6)
    h = max(y1 - y0, 1e-6)
    fig = plt.figure(figsize=(width_px / 100.0, width_px * h / w / 100.0),
                     dpi=100)
    ax = fig.add_axes([0, 0, 1, 1])
    ax.set_xlim(x0, x1)
    ax.set_ylim(y0, y1)
    ax.set_aspect("equal")
    ax.axis("off")
    return fig, ax


def _save(fig, path: str | None):
    plt = _pyplot()

    if path is not None:
        fig.savefig(path, facecolor="white")
    fig.canvas.draw()
    img = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return img


def render_pointclouds_grid(clouds, path: str | None = None, *,
                            colors=None, cols: int | None = None,
                            spacing: float = 1.1, view: np.ndarray | None = None,
                            point_size: float = 1.0, width_px: int = 1024):
    """Render a list of (N_i, 3) clouds side by side into one image.

    Equivalent of grid_points_lists_visulation + screenshot
    (reference: VisUtils.py:475-502, :264-283). colors: optional list of
    (N_i, 3) float [0,1] or uint8 [0,255] per-point colors (the reference
    divides txt colors by 255, :223). Returns the (H, W, 3) uint8 image."""
    view = DEFAULT_VIEW if view is None else view
    pts, cls, depth = [], [], []
    offs = _grid_offsets(len(clouds), cols, spacing)
    for i, c in enumerate(clouds):
        c = np.asarray(c)
        col = None if colors is None else np.asarray(colors[i], np.float64)
        if col is None and c.shape[1] > 3:  # packed [xyz rgb] dump rows
            col = c[:, 3:6].astype(np.float64)
        p = (_normalize_cloud(c[:, :3]) + offs[i]) @ view.T
        pts.append(p[:, :2])
        depth.append(p[:, 2])
        if col is not None and col.max() > 1.0:
            col = col / 255.0
        cls.append(np.broadcast_to(
            np.array([[0.25, 0.35, 0.55]]) if col is None else col,
            (p.shape[0], 3)))
    P = np.concatenate(pts)
    C = np.concatenate(cls)
    D = np.concatenate(depth)
    order = np.argsort(D)  # back-to-front
    pad = 0.6
    fig, ax = _canvas(width_px, ((P[:, 0].min() - pad, P[:, 0].max() + pad),
                                 (P[:, 1].min() - pad, P[:, 1].max() + pad)))
    ax.scatter(P[order, 0], P[order, 1], s=point_size,
               c=np.clip(C[order], 0, 1), linewidths=0, rasterized=True)
    return _save(fig, path)


def _face_shade(verts2: np.ndarray, verts3: np.ndarray, faces: np.ndarray,
                base_rgb: np.ndarray):
    """Painter-sorted faces + Lambert shade from view-space normals."""
    tri3 = verts3[faces]                      # (F, 3, 3) view space
    zmean = tri3[..., 2].mean(1)
    n = np.cross(tri3[:, 1] - tri3[:, 0], tri3[:, 2] - tri3[:, 0])
    nz = np.abs(n[:, 2]) / np.clip(np.linalg.norm(n, axis=1), 1e-12, None)
    shade = (0.35 + 0.65 * nz)[:, None] * base_rgb[None, :]
    order = np.argsort(zmean)
    return verts2[faces][order], np.clip(shade[order], 0, 1)


def render_meshes_grid(meshes, path: str | None = None, *,
                       colors=None, cols: int | None = None,
                       spacing: float = 1.2, view: np.ndarray | None = None,
                       width_px: int = 1024):
    """Render (vertices, faces) meshes side by side — faces 1-indexed like
    utils.mesh.tessellate_points emits. Equivalent of
    grid_meshes_lists_visulation + screenshot (reference: VisUtils.py
    :504-531, :286-308). Returns the (H, W, 3) uint8 image."""
    _pyplot()
    from matplotlib.collections import PolyCollection

    view = DEFAULT_VIEW if view is None else view
    offs = _grid_offsets(len(meshes), cols, spacing)
    polys, shades = [], []
    lo = np.array([np.inf, np.inf])
    hi = -lo
    for i, (verts, faces) in enumerate(meshes):
        faces = np.asarray(faces, np.int64)
        if faces.min() == 1:  # OBJ-style 1-indexed
            faces = faces - 1
        v = (_normalize_cloud(verts) + offs[i]) @ view.T
        base = (np.array([0.62, 0.66, 0.72]) if colors is None
                else np.asarray(colors[i], np.float64))
        if base.max() > 1.0:
            base = base / 255.0
        tri2, shade = _face_shade(v[:, :2], v, faces, base)
        polys.append(tri2)
        shades.append(shade)
        lo = np.minimum(lo, v[:, :2].min(0))
        hi = np.maximum(hi, v[:, :2].max(0))
    pad = 0.6
    fig, ax = _canvas(width_px, ((lo[0] - pad, hi[0] + pad),
                                 (lo[1] - pad, hi[1] + pad)))
    # one collection per mesh keeps per-mesh painter order; meshes do not
    # overlap on the grid so cross-mesh order is irrelevant
    for tri2, shade in zip(polys, shades):
        ax.add_collection(PolyCollection(
            tri2, facecolors=shade, edgecolors="none", rasterized=True))
    return _save(fig, path)


def vis_batch_in_grid(points: np.ndarray, path: str | None = None, *,
                      tessellate: bool = False, width_px: int = 1024):
    """B x N x 3(+3 rgb) batch -> one grid image (reference:
    VisUtils.py:202-243; square-ish height = sqrt(B)). With tessellate=True
    each cloud is treated as a sqrt(N) x sqrt(N) UV grid and rendered as a
    surface, like the reference's tessalate branch."""
    points = np.asarray(points)
    b = points.shape[0]
    rows = max(int(np.sqrt(b)), 1)
    cols = int(np.ceil(b / rows))
    if not tessellate:
        return render_pointclouds_grid(
            [points[i] for i in range(b)], path, cols=cols,
            width_px=width_px)
    from sednet_tpu_torch.utils.mesh import tessellate_points

    meshes = []
    for i in range(b):
        su = int(np.sqrt(points.shape[1]))
        v, f = tessellate_points(points[i, : su * su, :3], su, su)
        meshes.append((v, np.asarray(f)))
    return render_meshes_grid(meshes, path, cols=cols, width_px=width_px)


def save_images_rotations(clouds, path_template: str, *, n_views: int = 3,
                          meshes: bool = False, width_px: int = 1024):
    """Dump n_views images of the same shape collection under progressive
    60deg/45deg rotations (reference: save_images_shape_patches_collection,
    VisUtils.py:311-348 — 3 views stepped by euler(60deg, 45deg)).
    path_template gets .format(view_index). Returns the written paths."""
    step = _euler_rot(60 * np.pi / 180, 45 * np.pi / 180)
    view = np.eye(3)
    paths = []
    for i in range(n_views):
        p = path_template.format(i)
        if meshes:
            render_meshes_grid(clouds, p, view=view @ DEFAULT_VIEW,
                               width_px=width_px)
        else:
            render_pointclouds_grid(clouds, p, view=view @ DEFAULT_VIEW,
                                    width_px=width_px)
        paths.append(p)
        view = step @ view
    return paths
