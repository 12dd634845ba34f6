"""Blender/NeRF-synthetic scene reader (port of
``s3gaussian_tpu/data/blender.py``).

Parity: ``readNerfSyntheticInfo`` (scene/dataset_readers.py:289-365):
transforms_{train,test}.json, OpenGL->OpenCV flip, alpha compositing over
the background, random point init in [-1.3, 1.3]^3.
"""

from __future__ import annotations

import json
import os
import numpy as np
import torch

from s3gaussian_tpu_torch.data import images
from s3gaussian_tpu_torch.data.cameras import make_camera, nerf_norm_radius
from s3gaussian_tpu_torch.data.waymo import SceneInfo
from s3gaussian_tpu_torch.ops.transforms import focal2fov, fov2focal


def _read_split(path: str, transformsfile: str, white_background: bool,
                device: torch.device | str, extension: str = ".png"):
    cams = []
    with open(os.path.join(path, transformsfile)) as f:
        contents = json.load(f)
    fovx = contents["camera_angle_x"]
    for idx, frame in enumerate(contents["frames"]):
        file_path = os.path.join(path, frame["file_path"] + extension)
        c2w = np.array(frame["transform_matrix"])
        # OpenGL/Blender -> OpenCV camera axes
        c2w[:3, 1:3] *= -1
        w2c = np.linalg.inv(c2w)
        R = w2c[:3, :3].T
        T = w2c[:3, 3]
        time = frame.get("time", 0.0)
        image = None
        w = h = 800
        if os.path.exists(file_path):
            im = images.load_rgba(file_path)
            bg = np.ones(3) if white_background else np.zeros(3)
            image = im[..., :3] * im[..., 3:] + bg * (1 - im[..., 3:])
            h, w = image.shape[:2]
        fovy = focal2fov(fov2focal(fovx, w), h)
        cams.append(make_camera(R, T, fovx, fovy, w, h, time=time,
                                image=image, uid=idx, device=device))
    return cams


def read_blender_scene(path: str, white_background: bool = False,
                       eval_: bool = True, num_pts: int = 100_000,
                       device: torch.device | str = "cuda") -> SceneInfo:
    train = _read_split(path, "transforms_train.json", white_background,
                        device)
    test = []
    if os.path.exists(os.path.join(path, "transforms_test.json")):
        test = _read_split(path, "transforms_test.json", white_background,
                           device)
    if not eval_:
        train, test = train + test, []
    rng = np.random.default_rng(0)
    pts = (rng.random((num_pts, 3)).astype(np.float32) * 2.6 - 1.3)
    cols = rng.random((num_pts, 3)).astype(np.float32)
    centers = np.stack([c.campos.cpu().numpy() for c in train])
    aabb = np.array([[-1.3, -1.3, -1.3], [1.3, 1.3, 1.3]])
    return SceneInfo(points=pts, colors=cols, train_cameras=train,
                     test_cameras=test, full_cameras=train + test,
                     nerf_radius=nerf_norm_radius(centers), aabb=aabb)
