"""Raw ScanNet -> framework data preprocessing.

Python rebuild of the reference prep scripts
(data/scannet/load_scannet_data.py + batch_load_scannet_data.py):

  per scan:
    * read ``<scan>_vh_clean_2.ply`` mesh vertices (xyz + rgb),
    * read ``<scan>.aggregation.json`` (instance -> segments + raw label),
    * read ``<scan>_vh_clean_2.0.010000.segs.json`` (vertex -> segment),
    * read ``<scan>.txt`` (axisAlignment matrix),
    * map raw labels -> nyu40 ids via scannetv2-labels.combined.tsv,
    * compute per-instance axis-aligned boxes **in the aligned frame**
      (cx, cy, cz, dx, dy, dz, nyu40_label),
    * cap to 50 000 random points (batch_load_scannet_data.py:24-110),
    * store UNALIGNED points as float32 .bin + an mmdet3d-compatible info
      dict (points are re-aligned at load time by GlobalAlignment).

No external PLY dependency: a minimal reader for the
binary_little_endian / ascii vertex element is included.

A copy of ``nesie_tpu/data/scannet_prep.py`` (numpy only), so that a
machine without the JAX package can prepare the data the port reads.
"""
from __future__ import annotations

import csv
import json
import pickle
import struct
from pathlib import Path

import numpy as np

from nesie_tpu_torch.data.scannet_meta import CAT_ID_TO_CLASS, VALID_CAT_IDS

_PLY_TYPES = {
    "char": "b", "uchar": "B", "int8": "b", "uint8": "B",
    "short": "h", "ushort": "H", "int16": "h", "uint16": "H",
    "int": "i", "uint": "I", "int32": "i", "uint32": "I",
    "float": "f", "float32": "f", "double": "d", "float64": "d",
}


def read_ply_vertices(path):
    """Minimal PLY vertex reader -> dict of property name -> np array."""
    with open(path, "rb") as f:
        assert f.readline().strip() == b"ply"
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype_char)])
        cur = None
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("comment"):
                continue
            elif line.startswith("element"):
                _, name, count = line.split()
                cur = (name, int(count), [])
                elements.append(cur)
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    cur[2].append((parts[-1], "list", parts[2], parts[3]))
                else:
                    cur[2].append((parts[2], _PLY_TYPES[parts[1]]))
            elif line == "end_header":
                break

        name, count, props = elements[0]
        assert name == "vertex", "vertex element must come first"
        if fmt == "ascii":
            rows = [f.readline().split() for _ in range(count)]
            arr = np.array(rows, dtype=np.float64)
            return {p[0]: arr[:, i] for i, p in enumerate(props)}
        assert fmt == "binary_little_endian", f"unsupported PLY format {fmt}"
        fmt_str = "<" + "".join(p[1] for p in props)
        dtype = np.dtype([(p[0], "<" + p[1]) for p in props])
        data = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype)
        return {p[0]: np.asarray(data[p[0]]) for p in props}


def read_mesh_vertices_rgb(path):
    v = read_ply_vertices(path)
    return np.stack(
        [v["x"], v["y"], v["z"], v["red"], v["green"], v["blue"]], axis=1
    ).astype(np.float32)


def read_label_mapping(tsv_path, label_from="raw_category", label_to="nyu40id"):
    mapping = {}
    with open(tsv_path) as f:
        for row in csv.DictReader(f, delimiter="\t"):
            mapping[row[label_from]] = int(row[label_to])
    return mapping


def read_axis_align_matrix(meta_file):
    for line in open(meta_file):
        if "axisAlignment" in line:
            vals = [float(x) for x in line.split("=")[1].split()]
            return np.array(vals, np.float64).reshape(4, 4)
    return np.eye(4)


def export_scan(scan_dir, scan_name, label_map_file, max_num_points=50000,
                rng=None):
    """Process one raw scan directory.

    Returns dict with points (<=50k, 6), boxes (K, 7 incl. nyu40 label),
    axis_align_matrix, plus per-point instance/semantic ids.
    """
    scan_dir = Path(scan_dir)
    rng = rng or np.random.default_rng(0)
    mesh = read_mesh_vertices_rgb(scan_dir / f"{scan_name}_vh_clean_2.ply")
    label_map = read_label_mapping(label_map_file)
    aam = read_axis_align_matrix(scan_dir / f"{scan_name}.txt")

    agg = json.load(open(scan_dir / f"{scan_name}.aggregation.json"))
    segs = json.load(
        open(scan_dir / f"{scan_name}_vh_clean_2.0.010000.segs.json")
    )
    seg_ids = np.asarray(segs["segIndices"])

    num_verts = len(mesh)
    instance_ids = np.zeros(num_verts, np.int64)
    semantic_ids = np.zeros(num_verts, np.int64)
    object_labels = {}
    for group in agg["segGroups"]:
        obj_id = group["objectId"] + 1  # 1-indexed instances
        nyu40 = label_map.get(group["label"], 0)
        object_labels[obj_id] = nyu40
        mask = np.isin(seg_ids, group["segments"])
        instance_ids[mask] = obj_id
        semantic_ids[mask] = nyu40

    # aligned coordinates for box extraction
    aligned = mesh[:, :3] @ aam[:3, :3].T + aam[:3, 3]

    boxes = []
    for obj_id, nyu40 in sorted(object_labels.items()):
        if nyu40 not in VALID_CAT_IDS:
            continue
        pts = aligned[instance_ids == obj_id]
        if len(pts) == 0:
            continue
        mn, mx = pts.min(0), pts.max(0)
        boxes.append(np.concatenate([(mn + mx) / 2, mx - mn, [nyu40]]))
    boxes = (
        np.stack(boxes).astype(np.float32)
        if boxes else np.zeros((0, 7), np.float32)
    )

    if num_verts > max_num_points:
        choice = rng.choice(num_verts, max_num_points, replace=False)
        mesh = mesh[choice]
        instance_ids = instance_ids[choice]
        semantic_ids = semantic_ids[choice]

    return dict(
        points=mesh,
        boxes=boxes,
        axis_align_matrix=aam.astype(np.float32),
        instance_ids=instance_ids,
        semantic_ids=semantic_ids,
    )


def write_infos(scans, out_dir, split_name: str):
    """Write mmdet3d-compatible .bin points + scannet_infos_<split>.pkl.

    Args:
        scans: iterable of (scan_name, export_scan() dict).
    """
    out_dir = Path(out_dir)
    (out_dir / "points").mkdir(parents=True, exist_ok=True)
    infos = []
    for scan_name, data in scans:
        pts_path = f"points/{scan_name}.bin"
        data["points"].astype(np.float32).tofile(out_dir / pts_path)
        boxes = data["boxes"]
        # gt_boxes_upright_depth stores the minmax (gravity) center — the
        # reference's ScanNetDataset passes origin=(0.5, 0.5, 0.5)
        # (scannet_dataset.py:97-101); loaders convert to bottom-center.
        labels = np.array(
            [CAT_ID_TO_CLASS[int(b[6])] for b in boxes], np.int64
        )
        infos.append(
            dict(
                point_cloud=dict(num_features=6, lidar_idx=scan_name),
                pts_path=pts_path,
                annos={
                    "gt_num": len(boxes),
                    "gt_boxes_upright_depth": boxes[:, :6],
                    "class": labels,
                    "axis_align_matrix": data["axis_align_matrix"],
                },
            )
        )
    with open(out_dir / f"scannet_infos_{split_name}.pkl", "wb") as f:
        pickle.dump(infos, f)
    return infos
