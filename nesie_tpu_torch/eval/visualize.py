"""Result visualization dumps (reference
mmdet3d/core/visualizer/show_result.py): write the scene points and
predicted/GT boxes as Wavefront ``.obj`` files viewable in MeshLab.

Counterpart of ``nesie_tpu/eval/visualize.py``: numpy on the host, with
box corners and points-in-box from the port's ``core.boxes`` on CPU
float32 tensors. ``cv2`` and ``matplotlib`` are imported only by the
functions that draw on images or save a PNG.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

import torch

from nesie_tpu_torch.core.boxes import box_corners, points_in_boxes

_BOX_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def write_points_obj(path, points, colors=None):
    """points (N, >=3) -> .obj vertex cloud."""
    with open(path, "w") as f:
        for i, p in enumerate(np.asarray(points)):
            if colors is not None:
                c = np.asarray(colors[i]) / 255.0
                f.write(f"v {p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}\n")
            else:
                f.write(f"v {p[0]} {p[1]} {p[2]}\n")


def _corners(boxes) -> np.ndarray:
    """(K, 7) gravity-centered boxes -> (K, 8, 3) corners, in float32."""
    return box_corners(torch.as_tensor(np.asarray(boxes, np.float32))).numpy()


def write_boxes_obj(path, boxes):
    """boxes (K, 7) gravity-centered -> wireframe .obj."""
    corners = _corners(boxes)
    with open(path, "w") as f:
        for box in corners:
            for c in box:
                f.write(f"v {c[0]} {c[1]} {c[2]}\n")
        for k in range(len(corners)):
            base = 1 + 8 * k
            for a, b in _BOX_EDGES:
                f.write(f"l {base + a} {base + b}\n")


def project_pts_on_img(points, raw_img, proj, max_distance: float = 70.0,
                       radius: int = 1):
    """Draw a point cloud onto an image, depth-colored (reference
    image_vis.py:8-56 ``project_pts_on_img``; returns the image instead of
    opening a cv2 window).

    Args:
        points: (N, >=3) 3D points.
        raw_img: (H, W, 3) uint8.
        proj: (4, 4) 3D->image projection (the reference's lidar2img_rt /
            depth2img matrix).
    """
    import cv2
    from matplotlib import cm

    img = np.ascontiguousarray(np.asarray(raw_img).copy())
    pts = np.asarray(points)[:, :3]
    pts_4d = np.concatenate([pts, np.ones((len(pts), 1))], axis=-1)
    pts_2d = pts_4d @ np.asarray(proj).T
    depth = np.clip(pts_2d[:, 2], 1e-5, None)
    u = pts_2d[:, 0] / depth
    v = pts_2d[:, 1] / depth
    fov = (u >= 0) & (u < img.shape[1]) & (v >= 0) & (v < img.shape[0])
    cmap = (cm.hsv(np.linspace(0, 1, 256))[:, :3] * 255)
    for ui, vi, di in zip(u[fov], v[fov], depth[fov]):
        color = cmap[int(np.clip(max_distance * 10 / di, 0, 255))]
        cv2.circle(img, (int(round(ui)), int(round(vi))), radius,
                   tuple(float(c) for c in color), -1)
    return img


def draw_bbox3d_on_img(boxes, raw_img, proj, color=(0, 255, 0),
                       thickness: int = 1):
    """Project (K, 7) gravity-centered boxes and draw their wireframes
    (reference image_vis.py:59-121 ``plot_rect3d_on_img`` +
    ``draw_lidar_bbox3d_on_img``)."""
    import cv2

    img = np.ascontiguousarray(np.asarray(raw_img).copy())
    corners = _corners(boxes)
    k = corners.shape[0]
    pts_4d = np.concatenate(
        [corners.reshape(-1, 3), np.ones((k * 8, 1))], axis=-1
    )
    pts_2d = pts_4d @ np.asarray(proj).T
    depth = np.clip(pts_2d[:, 2], 1e-5, None)
    uv = (pts_2d[:, :2] / depth[:, None]).reshape(k, 8, 2)
    for box_uv in uv.astype(np.int64):
        for a, b in _BOX_EDGES:
            cv2.line(img, tuple(box_uv[a]), tuple(box_uv[b]), color,
                     thickness, cv2.LINE_AA)
    return img


def show_result(out_dir, name, points=None, gt_boxes=None, pred_boxes=None):
    """Dump <name>_points.obj / _gt.obj / _pred.obj into out_dir."""
    out = Path(out_dir) / name
    out.mkdir(parents=True, exist_ok=True)
    if points is not None:
        write_points_obj(out / f"{name}_points.obj", points)
    if gt_boxes is not None and len(gt_boxes):
        write_boxes_obj(out / f"{name}_gt.obj", gt_boxes)
    if pred_boxes is not None and len(pred_boxes):
        write_boxes_obj(out / f"{name}_pred.obj", pred_boxes)
    return out


# --------------------------------------------------------------------------
# Offscreen scene rendering (reference open3d_vis.py:319-442 ``Visualizer``).
# The reference opens an interactive open3d window and can screenshot it;
# headless hosts have no display, so this renders the same content
# (point cloud, wireframe boxes, points-in-box recoloring, seg-mask clouds)
# with a software z-buffer straight to a PNG.
# --------------------------------------------------------------------------


def _look_at_camera(points, elev_deg=55.0, azim_deg=-60.0):
    """Rotation + center placing an isometric-ish camera over the cloud."""
    center = points[:, :3].mean(0)
    el, az = np.deg2rad(elev_deg), np.deg2rad(azim_deg)
    ca, sa = np.cos(az), np.sin(az)
    ce, se = np.cos(el), np.sin(el)
    rot_z = np.array([[ca, -sa, 0.0], [sa, ca, 0.0], [0.0, 0.0, 1.0]])
    rot_x = np.array([[1.0, 0.0, 0.0], [0.0, ce, -se], [0.0, se, ce]])
    return (rot_x @ rot_z), center


def _project(pts, rot, center, scale, width, height):
    """World -> pixel coords + view depth (orthographic; the cloud spans
    the frame)."""
    v = (pts[:, :3] - center) @ rot.T
    px = (v[:, 0] * scale + width / 2.0).astype(np.int64)
    py = (height / 2.0 - v[:, 1] * scale).astype(np.int64)
    return px, py, v[:, 2]


def _splat(img, zbuf, px, py, depth, colors, size=2):
    h, w = zbuf.shape
    half = size // 2
    for dy in range(-half, half + 1):
        for dx in range(-half, half + 1):
            x = px + dx
            y = py + dy
            ok = (x >= 0) & (x < w) & (y >= 0) & (y < h)
            xi, yi, di = x[ok], y[ok], depth[ok]
            ci = colors[ok]
            order = np.argsort(di)  # far first; near overwrites
            xi, yi, di, ci = xi[order], yi[order], di[order], ci[order]
            keep = di >= zbuf[yi, xi] - 1e-9
            img[yi[keep], xi[keep]] = ci[keep]
            np.maximum.at(zbuf, (yi, xi), di)


class Visualizer:
    """Offscreen stand-in for the reference's open3d Visualizer
    (open3d_vis.py:319). Same surface: construct with points (+ optional
    gravity-centered depth-mode boxes), ``add_bboxes``, ``add_seg_mask``,
    ``show(save_path)`` -> writes a PNG instead of opening a window.
    """

    def __init__(self, points, bbox3d=None, save_path=None, points_size=2,
                 point_color=(0.5, 0.5, 0.5), bbox_color=(0, 1, 0),
                 points_in_box_color=(1, 0, 0), rot_axis=2,
                 center_mode="lidar_bottom", mode="xyz",
                 width=800, height=600):
        points = np.asarray(points, np.float64)
        self.points = points[:, :3].copy()
        if mode == "xyzrgb" and points.shape[1] >= 6:
            rgb = points[:, 3:6]
            if rgb.max() > 1.0:
                rgb = rgb / 255.0
            self.colors = rgb.copy()
        else:
            self.colors = np.tile(np.asarray(point_color, np.float64),
                                  (len(points), 1))
        self.points_size = points_size
        self.bbox_color = bbox_color
        self.points_in_box_color = points_in_box_color
        self.center_mode = center_mode
        self.rot_axis = rot_axis
        self.mode = mode
        self.width, self.height = width, height
        self.boxes = []  # (corners (K, 8, 3), color)
        self.seg_num = 0
        self._extra_clouds = []  # (points, colors)
        if bbox3d is not None and len(bbox3d):
            self.add_bboxes(bbox3d)

    def _gravity(self, bbox3d):
        b = np.asarray(bbox3d, np.float64).copy()
        # the reference shifts bottom-centered input to gravity center
        # along rot_axis: += dim/2 for lidar_bottom, -= dim/2 for
        # camera_bottom (open3d_vis.py:97-103)
        if self.center_mode == "lidar_bottom":
            b[:, self.rot_axis] += b[:, 3 + self.rot_axis] / 2.0
        elif self.center_mode == "camera_bottom":
            b[:, self.rot_axis] -= b[:, 3 + self.rot_axis] / 2.0
        return b

    def _to_z_up(self, arr3):
        """Swap coordinate columns so rot_axis plays the z role (identity
        for the default rot_axis=2)."""
        if self.rot_axis == 2:
            return arr3
        out = arr3.copy()
        out[:, [self.rot_axis, 2]] = out[:, [2, self.rot_axis]]
        return out

    def _boxes_z_up(self, b):
        """Boxes with yaw about rot_axis -> equivalent z-up boxes: swap
        center/dim columns (rot_axis <-> 2) and negate yaw (an axis swap
        flips handedness). Identity for rot_axis=2."""
        if self.rot_axis == 2:
            return b
        out = b.copy()
        out[:, [self.rot_axis, 2]] = out[:, [2, self.rot_axis]]
        out[:, [3 + self.rot_axis, 5]] = out[:, [5, 3 + self.rot_axis]]
        out[:, 6] = -out[:, 6]
        return out

    def add_bboxes(self, bbox3d, bbox_color=None, points_in_box_color=None):
        """Wireframe boxes + recolor the points inside them
        (open3d_vis.py:387-406)."""
        if bbox_color is None:
            bbox_color = self.bbox_color
        if points_in_box_color is None:
            points_in_box_color = self.points_in_box_color
        b = self._gravity(bbox3d)
        # corners/in-box math assumes yaw about z; for other rot_axis
        # values work in a swapped frame and swap the corners back
        bz = self._boxes_z_up(b)
        corners = _corners(bz)
        if self.rot_axis != 2:
            corners = corners.copy()
            corners[..., [self.rot_axis, 2]] = corners[..., [2, self.rot_axis]]
        self.boxes.append((corners, np.asarray(bbox_color, np.float64)))
        # the reference recolors in-box points only for plain-xyz clouds
        # (open3d_vis.py:111); b is already gravity-centered here, so
        # bottom_center=False.
        if self.mode == "xyz":
            inside = points_in_boxes(
                torch.as_tensor(self._to_z_up(self.points).astype(np.float32))[None],
                torch.as_tensor(bz.astype(np.float32))[None],
                bottom_center=False)[0].numpy()  # (N, K) bool
            self.colors[inside.any(-1)] = np.asarray(points_in_box_color,
                                                     np.float64)

    def add_seg_mask(self, seg_mask_colors):
        """Extra colorized cloud offset along +x (open3d_vis.py:407-428)."""
        self.seg_num += 1
        seg = np.asarray(seg_mask_colors, np.float64).copy()
        span = self.points[:, 0].max() - self.points[:, 0].min()
        seg[:, 0] += span * 1.2 * self.seg_num
        rgb = seg[:, 3:6]
        if rgb.size and rgb.max() > 1.0:
            rgb = rgb / 255.0
        self._extra_clouds.append((seg[:, :3], rgb))

    def render(self):
        """Rasterize to (H, W, 3) uint8."""
        all_pts = [self.points] + [p for p, _ in self._extra_clouds]
        world = np.concatenate(all_pts, 0)
        rot, center = _look_at_camera(world)
        v = (world - center) @ rot.T
        span = max(np.ptp(v[:, 0]), np.ptp(v[:, 1]), 1e-6)
        scale = 0.92 * min(self.width, self.height) / span

        img = np.ones((self.height, self.width, 3), np.float64)
        zbuf = np.full((self.height, self.width), -np.inf)

        clouds = [(self.points, self.colors)] + self._extra_clouds
        for pts, cols in clouds:
            px, py, d = _project(pts, rot, center, scale, self.width,
                                 self.height)
            _splat(img, zbuf, px, py, d, cols, self.points_size)

        for corners, color in self.boxes:
            for box in corners:
                for a, b in _BOX_EDGES:
                    seg = box[a][None] + np.linspace(0, 1, 96)[:, None] * (
                        box[b] - box[a])[None]
                    px, py, d = _project(seg, rot, center, scale,
                                         self.width, self.height)
                    # bias edges slightly toward the camera so they stay
                    # visible over the points they enclose
                    _splat(img, zbuf, px, py, d + 1e-3,
                           np.tile(color, (len(seg), 1)), size=1)
        return (np.clip(img, 0, 1) * 255).astype(np.uint8)

    def show(self, save_path=None):
        img = self.render()
        if save_path is not None:
            from matplotlib import image as mpimg

            mpimg.imsave(save_path, img)
        return img


def show_pts_boxes(points, bbox3d=None, show=False, save_path=None,
                   points_size=2, point_color=(0.5, 0.5, 0.5),
                   bbox_color=(0, 1, 0), points_in_box_color=(1, 0, 0)):
    """Offscreen analogue of open3d_vis.show_pts_boxes (open3d_vis.py:121)."""
    vis = Visualizer(points, bbox3d=bbox3d, points_size=points_size,
                     point_color=point_color, bbox_color=bbox_color,
                     points_in_box_color=points_in_box_color)
    return vis.show(save_path)
