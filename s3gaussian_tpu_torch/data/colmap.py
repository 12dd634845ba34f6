"""COLMAP scene reader, binary and text sparse models (port of
``s3gaussian_tpu/data/colmap.py``).

Parity: ``readColmapSceneInfo`` (scene/dataset_readers.py:187-287) +
``scene/colmap_loader.py`` — the generic-3DGS inheritance path.  Supports
PINHOLE and SIMPLE_PINHOLE cameras, the every-8th-image eval split
(llffhold), and points3D init.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from s3gaussian_tpu_torch.data import images
from s3gaussian_tpu_torch.data.cameras import make_camera, nerf_norm_radius
from s3gaussian_tpu_torch.data.waymo import SceneInfo
from s3gaussian_tpu_torch.ops.transforms import focal2fov


class ColmapCamera(NamedTuple):
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str


def qvec2rotmat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


CAMERA_MODELS = {0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4),
                 2: ("SIMPLE_RADIAL", 4), 3: ("RADIAL", 5),
                 4: ("OPENCV", 8)}


def read_cameras_binary(path) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            cid, model_id, w, h = struct.unpack("<iiQQ", f.read(24))
            name, np_ = CAMERA_MODELS[model_id]
            params = np.array(struct.unpack(f"<{np_}d", f.read(8 * np_)))
            out[cid] = ColmapCamera(name, int(w), int(h), params)
    return out


def read_images_binary(path) -> Dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            iid = struct.unpack("<i", f.read(4))[0]
            qvec = np.array(struct.unpack("<4d", f.read(32)))
            tvec = np.array(struct.unpack("<3d", f.read(24)))
            cam_id = struct.unpack("<i", f.read(4))[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            n2d = struct.unpack("<Q", f.read(8))[0]
            f.read(24 * n2d)
            out[iid] = ColmapImage(qvec, tvec, cam_id, name.decode())
    return out


def read_points3d_binary(path) -> Tuple[np.ndarray, np.ndarray]:
    xyzs, rgbs = [], []
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            _pid = struct.unpack("<Q", f.read(8))[0]
            xyz = struct.unpack("<3d", f.read(24))
            rgb = struct.unpack("<3B", f.read(3))
            f.read(8)  # error
            tl = struct.unpack("<Q", f.read(8))[0]
            f.read(8 * tl)
            xyzs.append(xyz)
            rgbs.append(rgb)
    return (np.array(xyzs, np.float32),
            np.array(rgbs, np.float32) / 255.0)


def read_cameras_text(path) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.split()
            out[int(parts[0])] = ColmapCamera(
                parts[1], int(parts[2]), int(parts[3]),
                np.array([float(p) for p in parts[4:]]))
    return out


def read_images_text(path) -> Dict[int, ColmapImage]:
    out = {}
    with open(path) as f:
        lines = [l for l in f if not l.startswith("#") and l.strip()]
    for meta in lines[::2]:  # every other line is the 2D point list
        parts = meta.split()
        out[int(parts[0])] = ColmapImage(
            np.array([float(p) for p in parts[1:5]]),
            np.array([float(p) for p in parts[5:8]]),
            int(parts[8]), parts[9])
    return out


def read_points3d_text(path) -> Tuple[np.ndarray, np.ndarray]:
    xyzs, rgbs = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.split()
            xyzs.append([float(p) for p in parts[1:4]])
            rgbs.append([float(p) for p in parts[4:7]])
    return (np.array(xyzs, np.float32),
            np.array(rgbs, np.float32) / 255.0)


def read_colmap_scene(path: str, images_dir: str = "images",
                      eval_: bool = True, llffhold: int = 8,
                      device: torch.device | str = "cuda") -> SceneInfo:
    sparse = os.path.join(path, "sparse", "0")
    if os.path.exists(os.path.join(sparse, "cameras.bin")):
        cams = read_cameras_binary(os.path.join(sparse, "cameras.bin"))
        imgs = read_images_binary(os.path.join(sparse, "images.bin"))
        xyz, rgb = read_points3d_binary(os.path.join(sparse, "points3D.bin"))
    else:  # text-format model (colmap_loader.py:125-272 fallback order)
        cams = read_cameras_text(os.path.join(sparse, "cameras.txt"))
        imgs = read_images_text(os.path.join(sparse, "images.txt"))
        xyz, rgb = read_points3d_text(os.path.join(sparse, "points3D.txt"))

    cam_list = []
    for idx, (iid, im) in enumerate(sorted(imgs.items(), key=lambda kv: kv[1].name)):
        cc = cams[im.camera_id]
        R = qvec2rotmat(im.qvec).T  # stored transposed like the reference
        T = im.tvec
        if cc.model == "SIMPLE_PINHOLE":
            focal_x = focal_y = cc.params[0]
        else:
            focal_x, focal_y = cc.params[0], cc.params[1]
        fovx = focal2fov(focal_x, cc.width)
        fovy = focal2fov(focal_y, cc.height)
        img_path = os.path.join(path, images_dir, im.name)
        image = None
        if os.path.exists(img_path):
            image = images.load_rgb(img_path)
        cam_list.append(make_camera(R, T, fovx, fovy, cc.width, cc.height,
                                    time=0.0, image=image, uid=idx,
                                    device=device))

    if eval_:
        train = [c for i, c in enumerate(cam_list) if i % llffhold != 0]
        test = [c for i, c in enumerate(cam_list) if i % llffhold == 0]
    else:
        train, test = cam_list, []
    centers = np.stack([c.campos.cpu().numpy() for c in train])
    aabb = np.stack([xyz.min(0), xyz.max(0)])
    return SceneInfo(points=xyz, colors=rgb, train_cameras=train,
                     test_cameras=test, full_cameras=cam_list,
                     nerf_radius=nerf_norm_radius(centers), aabb=aabb)
