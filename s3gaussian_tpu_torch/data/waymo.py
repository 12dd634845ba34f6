"""Waymo clip reader (port of ``s3gaussian_tpu/data/waymo.py``, itself a
numpy port of ``readWaymoInfo``
(scene/dataset_readers.py:597-1093) over the preprocessed on-disk layout
(docs/prepare_data.md): ``images/{t:03d}_{cam}.jpg``, per-camera
``intrinsics/{i}.txt`` + ``extrinsics/{i}.txt``, ``ego_pose/{t:03d}.txt``,
``lidar/{t:03d}.bin`` (N×10 float32: origins, points, ground, intensity,
elongation, laser_id), optional sky/dynamic masks and DINO features.

Behaviors preserved exactly:
  * cameras [1, 0, 2] = FRONT_LEFT, FRONT, FRONT_RIGHT; images resized to
    640×960, intrinsics rescaled from the original 1280×1920;
  * ego poses rebased to the first frame; lidar frame == ego frame;
  * camera-frustum AABB from the 4 image corners at 0.01 / 80 m;
  * train/test split: ``t % stride != 0 or t == 0`` trains (NVS);
  * lidar truncation x∈(−2, 80) in ego frame; sparse per-camera depth maps
    by projecting world lidar points with the rescaled intrinsics;
  * voxel dedup (GridSample3D, voxel 0.013) then random downsample to
    ``num_pts``; points clipped to the frustum AABB;
  * timestamps normalized to [0,1] over [original_start_time, end_time).

Everything up to the cameras is numpy, as in the JAX package; images and
masks are read by ``data/images.py`` (by content, PNG without PIL), and
each camera's tensors are put on the device the caller names.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from s3gaussian_tpu_torch.data import images
from s3gaussian_tpu_torch.data.cameras import (Camera, make_camera,
                                               nerf_norm_radius)
from s3gaussian_tpu_torch.ops.transforms import focal2fov

ORIGINAL_SIZE = [[1280, 1920], [1280, 1920], [1280, 1920], [884, 1920], [884, 1920]]
OPENCV2DATASET = np.array(
    [[0, 0, 1, 0], [-1, 0, 0, 0], [0, -1, 0, 0], [0, 0, 0, 1]], dtype=np.float64)
LOAD_SIZE = [640, 960]          # (h, w)
CAMERA_LIST = [1, 0, 2]
TRUNCATED_RANGE = (-2.0, 80.0)
FRUSTUM_RANGE = (0.01, 80.0)


@dataclass
class SceneInfo:
    points: np.ndarray            # [P,3]
    colors: np.ndarray            # [P,3]
    train_cameras: List[Camera]
    test_cameras: List[Camera]
    full_cameras: List[Camera]
    nerf_radius: float            # cameras_extent
    aabb: np.ndarray              # [2,3] cam-frustum aabb (min, max)
    occ_grid: Optional[np.ndarray] = None
    max_time: float = 1.0
    # panoptic-object bookkeeping (dataset_readers.py:1056-1071)
    num_panoptic_objects: int = 0
    panoptic_object_ids: Optional[list] = None
    panoptic_id_to_idx: Optional[dict] = None


def _load_mask(path: str, size_hw) -> np.ndarray:
    return images.load_channel0(path, size_hw) > 0


def grid_sample_3d(points: np.ndarray, colors: np.ndarray,
                   voxel_size: float = 0.013) -> Tuple[np.ndarray, np.ndarray]:
    """Voxel dedup keeping the first point per voxel, in voxel-sorted order
    (GridSample3D, dataset_readers.py:1102-1132)."""
    q = np.around(points[:, :3] / voxel_size)
    q -= q.min(axis=0)
    bound = q.max(axis=0) - q.min(axis=0)
    vidx = q[:, 0] * bound[1] * bound[2] + q[:, 1] * bound[2] + q[:, 2]
    order = np.argsort(vidx)
    v = vidx[order]
    first = np.ones(len(v), dtype=bool)
    first[1:] = v[1:] != v[:-1]
    keep = order[first]
    return points[keep], colors[keep]


def get_occ_grid(points: np.ndarray, aabb: np.ndarray,
                 voxel_size: float) -> np.ndarray:
    """Occupancy grid over the frustum aabb (utils/general_utils.py:37-55)."""
    shape = np.ceil((aabb[1] - aabb[0]) / voxel_size).astype(int)
    grid = np.zeros(shape, dtype=bool)
    vc = np.floor((points - aabb[0]) / voxel_size).astype(int)
    ok = np.all((vc >= 0) & (vc < shape), axis=1)
    vc = vc[ok]
    grid[vc[:, 0], vc[:, 1], vc[:, 2]] = True
    return grid


def _feat_pca3(feat_path: str, size_hw, rng: np.random.Generator) -> np.ndarray:
    """Per-image DINO feature → PCA(3) → [0,1] → nearest-patch upsample
    (dataset_readers.py:485-581)."""
    features = np.load(feat_path).squeeze()          # [h', w', C]
    hh, ww, c = features.shape
    flat = features.reshape(-1, c)
    n_sample = min(100_000, flat.shape[0])
    sel = flat[rng.choice(flat.shape[0], n_sample, replace=False)]
    mean = sel.mean(axis=0)
    _, _, vt = np.linalg.svd(sel - mean, full_matrices=False)
    reduce_mat = vt[:3].T                            # [C,3]
    red = features @ reduce_mat                      # [h',w',3]
    fmin = red.reshape(-1, 3).min(axis=0)
    fmax = red.reshape(-1, 3).max(axis=0)
    red = (red - fmin) / np.maximum(fmax - fmin, 1e-12)
    # nearest-patch upsample to pixels
    sy = hh / size_hw[0]
    sx = ww / size_hw[1]
    yy = np.minimum((np.arange(size_hw[0]) * sy).astype(int), hh - 1)
    xx = np.minimum((np.arange(size_hw[1]) * sx).astype(int), ww - 1)
    return red[yy[:, None], xx[None, :]].astype(np.float32)


def _load_id_map(path: str, size_hw) -> np.ndarray:
    """Integer id map (.npy semantic/instance labels) with NEAREST resize
    (dataset_readers.py:443-460)."""
    arr = np.load(path).squeeze()
    sy = arr.shape[0] / size_hw[0]
    sx = arr.shape[1] / size_hw[1]
    yy = np.minimum((np.arange(size_hw[0]) * sy).astype(int), arr.shape[0] - 1)
    xx = np.minimum((np.arange(size_hw[1]) * sx).astype(int), arr.shape[1] - 1)
    return arr[yy[:, None], xx[None, :]].astype(np.int32)


def panoptic_object_ids(cams) -> Tuple[int, list, dict]:
    """Unique panoptic ids (semantic*1000 + instance) over train+test cams
    (dataset_readers.py:1056-1071, utils/segmentation_utils.py:68-80)."""
    ids = []
    for c in cams:
        if c.semantic_mask is not None and c.instance_mask is not None:
            pan = (c.semantic_mask.cpu().numpy().astype(np.int64) * 1000
                   + c.instance_mask.cpu().numpy().astype(np.int64))
            ids.append(np.unique(pan))
    if not ids:
        return 0, [], {}
    uniq = np.unique(np.concatenate(ids)).tolist()
    return len(uniq), uniq, {pid: i for i, pid in enumerate(uniq)}


def read_waymo(path: str, white_background: bool = False, eval_: bool = True,
               load_sky_mask: bool = False, load_dynamic_mask: bool = True,
               load_panoptic_mask: bool = False, load_sam_mask: bool = False,
               load_feat_map: bool = False, start_time: int = 0,
               end_time: int = -1, original_start_time: int = 0,
               num_pts: int = 1_500_000, stride: int = 0,
               save_occ_grid: bool = True, occ_voxel_size: float = 0.4,
               recompute_occ_grid: bool = False,
               load_size=None, seed: int = 0,
               device: torch.device | str = "cuda") -> SceneInfo:
    ls = list(load_size) if load_size is not None else list(LOAD_SIZE)
    image_folder = os.path.join(path, "images")
    frame_ids = {f.split("_")[0] for f in os.listdir(image_folder)}
    num_frames = len(frame_ids)
    if end_time == -1:
        end_time = num_frames
    else:
        # reference semantics: end_time is inclusive; clamp to the clip
        end_time = min(end_time + 1, num_frames)

    # --- intrinsics / extrinsics per camera ---
    _intrinsics, cam_to_egos = [], []
    for i in range(max(CAMERA_LIST) + 1):
        intr = np.loadtxt(os.path.join(path, "intrinsics", f"{i}.txt"))
        fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
        fx *= ls[1] / ORIGINAL_SIZE[i][1]
        fy *= ls[0] / ORIGINAL_SIZE[i][0]
        cx *= ls[1] / ORIGINAL_SIZE[i][1]
        cy *= ls[0] / ORIGINAL_SIZE[i][0]
        _intrinsics.append(np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]]))
        c2e = np.loadtxt(os.path.join(path, "extrinsics", f"{i}.txt"))
        cam_to_egos.append(c2e @ OPENCV2DATASET)

    # --- per-frame poses rebased to the first frame ---
    ego_start = np.loadtxt(os.path.join(path, "ego_pose", f"{start_time:03d}.txt"))
    cam_to_worlds, intrinsics, cam_ids, timestamps = [], [], [], []
    lidar_to_worlds = []
    for t in range(start_time, end_time):
        ego = np.loadtxt(os.path.join(path, "ego_pose", f"{t:03d}.txt"))
        ego_to_world = np.linalg.inv(ego_start) @ ego
        lidar_to_worlds.append(ego_to_world)
        for cam_id in CAMERA_LIST:
            cam_to_worlds.append(ego_to_world @ cam_to_egos[cam_id])
            intrinsics.append(_intrinsics[cam_id])
            cam_ids.append(cam_id)
            timestamps.append(t - start_time)
    cam_to_worlds = np.stack(cam_to_worlds)
    intrinsics = np.stack(intrinsics)
    timestamps = np.array(timestamps)

    # --- frustum AABB (dataset_readers.py:749-781) ---
    pix_corners = np.array([[0, 0], [0, ls[0]],
                            [ls[1], ls[0]], [ls[1], 0]])
    corners = []
    for c2w, intr in zip(cam_to_worlds, intrinsics):
        for extent in FRUSTUM_RANGE:
            cc = np.linalg.inv(intr) @ np.concatenate(
                [pix_corners, np.ones((4, 1))], axis=-1).T * extent
            wc = c2w[:3, :3] @ cc + c2w[:3, 3:4]
            corners.append(wc.T)
    corners = np.concatenate(corners, 0)
    aabb = np.stack([corners.min(axis=0), corners.max(axis=0)], 0)

    # --- split (dataset_readers.py:784-796) ---
    if stride != 0:
        train_mask = (timestamps % stride != 0) | (timestamps == 0)
    else:
        train_mask = np.ones(len(timestamps), dtype=bool)
    test_mask = ~train_mask

    # --- lidar → world points + sparse depth maps ---
    rng = np.random.default_rng(seed)
    all_points = []
    depth_maps = []
    for ti, t in enumerate(range(start_time, end_time)):
        lp = os.path.join(path, "lidar", f"{t:03d}.bin")
        info = np.fromfile(lp, dtype=np.float32).reshape(-1, 10)
        pts = info[:, 3:6]
        ok = (pts[:, 0] > TRUNCATED_RANGE[0]) & (pts[:, 0] < TRUNCATED_RANGE[1])
        pts = pts[ok]
        l2w = lidar_to_worlds[ti]
        wpts = (l2w[:3, :3] @ pts.T + l2w[:3, 3:4]).T
        all_points.append(wpts)
        for ci in range(len(CAMERA_LIST)):
            c2w = cam_to_worlds[len(CAMERA_LIST) * ti + ci]
            w2c = np.linalg.inv(c2w)
            cam_pts = (w2c[:3, :3] @ wpts.T + w2c[:3, 3:4]).T
            pix = (intrinsics[len(CAMERA_LIST) * ti + ci] @ cam_pts.T).T
            front = pix[:, 2] > 0
            pix = pix[front]
            uv = pix[:, :2] / pix[:, 2:]
            inb = ((uv[:, 0] >= 0) & (uv[:, 0] < ls[1])
                   & (uv[:, 1] >= 0) & (uv[:, 1] < ls[0]))
            pix, uv = pix[inb], uv[inb]
            dm = np.zeros(ls, np.float32)
            dm[uv[:, 1].astype(np.int32), uv[:, 0].astype(np.int32)] = pix[:, 2]
            depth_maps.append(dm)

    points = np.concatenate(all_points, 0)
    colors = rng.random((len(points), 3)).astype(np.float32) / 255.0
    colors = colors * 0.28209479177387814 + 0.5  # SH2RGB of random shs
    inb = np.all((points >= aabb[0]) & (points <= aabb[1]), axis=-1)
    points, colors = points[inb], colors[inb]

    occ_grid = None
    if save_occ_grid:
        occ_path = os.path.join(path, "occ_grid.npy")
        if os.path.exists(occ_path) and not recompute_occ_grid:
            occ_grid = np.load(occ_path)
        else:
            occ_grid = get_occ_grid(points, aabb, occ_voxel_size)
            try:
                np.save(occ_path, occ_grid)
            except OSError:
                pass

    points, colors = grid_sample_3d(points, colors)
    if len(points) > num_pts:
        sel = rng.choice(len(points), num_pts, replace=False)
        points, colors = points[sel], colors[sel]

    # --- timestamps → [0,1] (dataset_readers.py:677-686) ---
    time_length = max(end_time - original_start_time - 1, 1)

    def norm_time(t_frame: int) -> float:
        return (t_frame - original_start_time) / time_length

    # --- cameras ---
    def build_camera(idx: int) -> Camera:
        t = timestamps[idx]
        frame = t + start_time
        c2w = cam_to_worlds[idx]
        w2c = np.linalg.inv(c2w)
        R = w2c[:3, :3].T
        T = w2c[:3, 3]
        intr = intrinsics[idx]
        fovx = focal2fov(intr[0, 0], ls[1])
        fovy = focal2fov(intr[1, 1], ls[0])
        cam_id = cam_ids[idx]
        img = images.load_rgb(
            os.path.join(path, "images", f"{frame:03d}_{cam_id}.jpg"),
            ls)
        dyn = sky = feat = None
        dm_path = os.path.join(path, "dynamic_masks", f"{frame:03d}_{cam_id}.png")
        if load_dynamic_mask and os.path.exists(dm_path):
            dyn = _load_mask(dm_path, ls)
        sm_path = os.path.join(path, "sky_masks", f"{frame:03d}_{cam_id}.png")
        if load_sky_mask and os.path.exists(sm_path):
            sky = _load_mask(sm_path, ls)
        fm_path = os.path.join(path, "dinov2_vitb14", f"{frame:03d}_{cam_id}.npy")
        if load_feat_map and os.path.exists(fm_path):
            feat = _feat_pca3(fm_path, ls, rng)
        sem = inst = sam = None
        if load_panoptic_mask:
            sp = os.path.join(path, "semantic_segs", f"{frame:03d}_{cam_id}.npy")
            ip = os.path.join(path, "instance_segs", f"{frame:03d}_{cam_id}.npy")
            if os.path.exists(sp):
                sem = _load_id_map(sp, ls)
            if os.path.exists(ip):
                inst = _load_id_map(ip, ls)
        if load_sam_mask:
            sam_p = os.path.join(path, "sam_masks", f"{frame:03d}_{cam_id}.jpg")
            if os.path.exists(sam_p):
                sam = images.load_channel0(sam_p, ls).astype(np.int32)
        # reference time: mapper[absolute frame] = (frame - orig)/length
        # (dataset_readers.py:677-686, 992-999)
        return make_camera(R, T, fovx, fovy, ls[1], ls[0],
                           time=norm_time(frame),
                           image=img, depth_map=depth_maps[idx],
                           dynamic_mask=dyn, sky_mask=sky, feat_map=feat,
                           semantic_mask=sem, instance_mask=inst,
                           sam_mask=sam,
                           uid=idx, cam_idx=cam_id, frame_idx=int(t),
                           device=device)

    train_idx = np.where(train_mask)[0]
    test_idx = np.where(test_mask)[0]
    train_cams = [build_camera(i) for i in train_idx]
    test_cams = [build_camera(i) for i in test_idx]
    if len(test_idx) == 0:
        full_cams = train_cams
    else:
        full_cams = [build_camera(i) for i in range(len(timestamps))]

    if not eval_:
        train_cams = train_cams + test_cams
        test_cams = []

    centers = np.stack([c.campos.cpu().numpy() for c in train_cams])
    radius = nerf_norm_radius(centers)

    n_pan, pan_ids, pan_map = (panoptic_object_ids(train_cams + test_cams)
                               if load_panoptic_mask else (0, None, None))

    return SceneInfo(points=points.astype(np.float32), colors=colors,
                     train_cameras=train_cams, test_cameras=test_cams,
                     full_cameras=full_cams, nerf_radius=radius, aabb=aabb,
                     occ_grid=occ_grid,
                     max_time=norm_time(end_time - 1 - start_time),
                     num_panoptic_objects=n_pan,
                     panoptic_object_ids=pan_ids,
                     panoptic_id_to_idx=pan_map)
