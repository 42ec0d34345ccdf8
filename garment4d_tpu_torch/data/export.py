"""Per-frame export and preview rendering.

Counterpart of `garment4d_tpu/data/export.py` (reference
`utils/post_processing.py:235-385`: the segmentation-coloured PLY and the
OBJ writers; `utils/nr_utils.py`: save_obj and the render). The reference's
neural_renderer preview is a small orthographic, z-buffered,
Lambert-shaded software rasteriser here. numpy only (matplotlib writes the
PNGs where it is installed, else binary PPM/PGM); the files are
byte-identical to the JAX package's.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from garment4d_tpu_torch.data.obj_io import write_obj
from garment4d_tpu_torch.models.assets import LABEL_DICT

# RGB of each class; SEG_COLORS[l] colours the 0-based label l, the class
# whose LABEL_DICT value is l + 1
_CLASS_COLORS = {
    "Body": (180, 180, 180),
    "Skirt": (230, 60, 60),
    "Dress": (60, 170, 60),
    "Jumpsuit": (60, 60, 230),
    "Top": (230, 170, 40),
    "Trousers": (150, 70, 200),
    "Tshirt": (50, 200, 220),
}
SEG_COLORS = np.array([_CLASS_COLORS[name] for name in sorted(LABEL_DICT, key=LABEL_DICT.get)],
                      np.uint8)


def write_ply_pointcloud(path: str, points: np.ndarray,
                         labels: Optional[np.ndarray] = None) -> None:
    """ASCII PLY point cloud, coloured by the 0-based `labels` if given."""
    points = np.asarray(points).reshape(-1, 3)
    has_color = labels is not None
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if has_color:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        if has_color:
            cols = SEG_COLORS[np.asarray(labels).reshape(-1) % len(SEG_COLORS)]
            for p, c in zip(points, cols):
                f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {c[0]} {c[1]} {c[2]}\n")
        else:
            for p in points:
                f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")


def render_mesh(vertices: np.ndarray, faces: np.ndarray, size: int = 256,
                axis: int = 2) -> np.ndarray:
    """Orthographic z-buffered render along `axis` -> (size, size) float64
    image, each pixel the |normal . axis| shade of its nearest triangle
    (the reference's 256 x 256 preview, `nr_utils.py:33-86`)."""
    v = np.asarray(vertices, np.float64).copy()
    f = np.asarray(faces, np.int64)
    keep = [i for i in range(3) if i != axis]
    lo, hi = v[:, keep].min(0), v[:, keep].max(0)
    scale = (size - 4) / max((hi - lo).max(), 1e-6)
    xy = (v[:, keep] - lo) * scale + 2.0
    z = v[:, axis]

    img = np.zeros((size, size), np.float64)
    zbuf = np.full((size, size), -np.inf)

    e1 = v[f[:, 1]] - v[f[:, 0]]
    e2 = v[f[:, 2]] - v[f[:, 0]]
    n = np.cross(e1, e2)
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-9)
    shade = np.abs(n[:, axis])

    for fi, tri in enumerate(f):
        pts = xy[tri]
        zs = z[tri].mean()
        x0, y0 = np.floor(pts.min(0)).astype(int)
        x1, y1 = np.ceil(pts.max(0)).astype(int)
        x0, y0 = max(x0, 0), max(y0, 0)
        x1, y1 = min(x1, size - 1), min(y1, size - 1)
        if x1 < x0 or y1 < y0:
            continue
        gx, gy = np.meshgrid(np.arange(x0, x1 + 1), np.arange(y0, y1 + 1))
        p = np.stack([gx.ravel(), gy.ravel()], 1).astype(np.float64)
        d = pts[1:] - pts[0]
        det = d[0, 0] * d[1, 1] - d[0, 1] * d[1, 0]
        if abs(det) < 1e-12:
            continue
        rel = p - pts[0]
        u = (rel[:, 0] * d[1, 1] - rel[:, 1] * d[1, 0]) / det
        w = (-rel[:, 0] * d[0, 1] + rel[:, 1] * d[0, 0]) / det
        mask = (u >= 0) & (w >= 0) & (u + w <= 1)
        px, py = gx.ravel()[mask], gy.ravel()[mask]
        better = zs > zbuf[py, px]
        img[py[better], px[better]] = shade[fi]
        zbuf[py[better], px[better]] = zs
    return img


def save_image(path: str, image: np.ndarray) -> None:
    """Save a grayscale (H, W) or RGB (H, W, 3) float image scaled to its
    maximum (reference `nr_utils.save_images`): a PNG through matplotlib
    where it is installed, else binary PGM / PPM."""
    img = np.asarray(image, np.float64)
    img = np.clip(img / max(img.max(), 1e-9), 0, 1)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.imsave(path, img, cmap=None if img.ndim == 3 else "gray")
        return
    except Exception:
        pass
    data = (img * 255).astype(np.uint8)
    with open(path, "wb") as f:
        if data.ndim == 2:
            f.write(b"P5\n%d %d\n255\n" % (data.shape[1], data.shape[0]))
        else:
            f.write(b"P6\n%d %d\n255\n" % (data.shape[1], data.shape[0]))
        f.write(data.tobytes())


def export_frame(output_dir: str, tag: str, result: Dict[str, np.ndarray],
                 garment_faces: Optional[np.ndarray] = None,
                 body_faces: Optional[np.ndarray] = None) -> None:
    """Write one frame's results under `output_dir` (reference
    `process_single_frame`, `post_processing.py:235-331`): `{tag}_pcd.ply`
    (coloured by `pcd_labels` if given), `{tag}_pred_garment.obj`,
    `{tag}_gt_garment.obj` and `{tag}_body.obj`, each where its key is in
    `result`: pcd (N, 3), pcd_labels (N,), pred_garment (Vg, 3),
    gt_garment (Vg, 3), body (Vb, 3)."""
    os.makedirs(output_dir, exist_ok=True)
    if "pcd" in result:
        write_ply_pointcloud(
            os.path.join(output_dir, f"{tag}_pcd.ply"),
            result["pcd"], result.get("pcd_labels"))
    if "pred_garment" in result:
        write_obj(os.path.join(output_dir, f"{tag}_pred_garment.obj"),
                  result["pred_garment"], garment_faces)
    if "gt_garment" in result:
        write_obj(os.path.join(output_dir, f"{tag}_gt_garment.obj"),
                  result["gt_garment"], garment_faces)
    if "body" in result:
        write_obj(os.path.join(output_dir, f"{tag}_body.obj"),
                  result["body"], body_faces)
