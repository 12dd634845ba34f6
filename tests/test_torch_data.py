"""The port's scene readers against the JAX package's on the same files:
the PNG decoder against PIL, ``read_waymo`` on the fabricated clip (once
with its JPEG images, once with a copy whose images hold PNG content, plus
sky, SAM and feature maps), the stride split, the Blender and COLMAP
(text and binary) readers, ``load_scene``'s dispatch and pool capacity,
and ``cameras.json``.

Images, depth maps, masks, points and colours must be exact; camera
matrices agree to rtol 1e-6; aabb, radius and ``max_time`` are equal.
"""

import json
import os
import shutil
import struct
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from s3gaussian_tpu.config import ModelParams as JMP
from s3gaussian_tpu.data import blender as jblender
from s3gaussian_tpu.data import cameras as jcameras
from s3gaussian_tpu.data import colmap as jcolmap
from s3gaussian_tpu.data import scene as jscene
from s3gaussian_tpu.data import waymo as jwaymo
from s3gaussian_tpu_torch.config import ModelParams as TMP
from s3gaussian_tpu_torch.data import blender as tblender
from s3gaussian_tpu_torch.data import cameras as tcameras
from s3gaussian_tpu_torch.data import colmap as tcolmap
from s3gaussian_tpu_torch.data import images
from s3gaussian_tpu_torch.data import scene as tscene
from s3gaussian_tpu_torch.data import waymo as twaymo

from test_blender_reader import make_blender_fixture
from waymo_fixture import make_fixture
from torch_threads import one_torch_thread  # noqa: F401

# ---------------------------------------------------------------------------
# PNG decoding
# ---------------------------------------------------------------------------


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def encode_png(arr, filters):
    """A PNG of uint8 ``arr`` ([H, W] or [H, W, C]) with row r filtered by
    ``filters[r]`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    arr = np.asarray(arr, np.uint8)
    c = 1 if arr.ndim == 2 else arr.shape[2]
    h, w = arr.shape[:2]
    rows = arr.reshape(h, w * c).astype(np.int64)
    body = bytearray()
    prev = np.zeros(w * c, np.int64)
    for r in range(h):
        raw, out = rows[r], []
        for x in range(w * c):
            a = raw[x - c] if x >= c else 0
            b = prev[x]
            cc = prev[x - c] if x >= c else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, cc))[filters[r]]
            out.append((raw[x] - pred) % 256)
        body += bytes([filters[r]]) + bytes(out)
        prev = raw

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (images.PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(body)))
            + chunk(b"IEND", b""))


MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_png_decoder_matches_pil_over_all_five_filters(mode, tmp_path):
    rng = np.random.default_rng(MODES[mode])
    shape = (23, 17) if mode == "L" else (23, 17, MODES[mode])
    arr = rng.integers(0, 256, shape, dtype=np.uint8)
    filters = [r % 5 for r in range(23)]
    rng.shuffle(filters[10:])
    path = str(tmp_path / "a.png")
    with open(path, "wb") as f:
        f.write(encode_png(arr, filters))
    pil = Image.open(path)
    assert pil.mode == mode
    np.testing.assert_array_equal(images.decode_png(open(path, "rb").read()),
                                  np.asarray(pil))
    np.testing.assert_array_equal(np.asarray(pil), arr)
    np.testing.assert_array_equal(
        images.load_rgb(path), np.asarray(pil.convert("RGB"), np.float32) / 255)
    np.testing.assert_array_equal(
        images.load_rgba(path),
        np.asarray(pil.convert("RGBA"), np.float32) / 255)


def test_png_written_by_pil_and_by_write_png(tmp_path):
    """PIL's own adaptive filters decode bit-exactly; ``write_png`` files
    read back through PIL; a resize goes through PIL's BILINEAR."""
    rng = np.random.default_rng(0)
    arr = (rng.random((40, 56, 3)) * 255).astype(np.uint8)
    arr[10:30] = arr[10:30] // 7          # smooth bands: several filters
    pil_path, own_path = str(tmp_path / "pil.png"), str(tmp_path / "own.png")
    Image.fromarray(arr).save(pil_path)
    images.write_png(own_path, arr)
    np.testing.assert_array_equal(images.read_image(pil_path)[0], arr)
    np.testing.assert_array_equal(np.asarray(Image.open(own_path)), arr)
    want = np.asarray(Image.fromarray(arr).resize((28, 20), Image.BILINEAR),
                      np.float32) / 255
    np.testing.assert_array_equal(images.load_rgb(own_path, (20, 28)), want)


def test_other_formats_go_through_pil(tmp_path, monkeypatch):
    """A JPEG (named .png) and a palette PNG are decoded by PIL, by
    content; without PIL they raise ImportError naming the file, while an
    8-bit RGB PNG still decodes."""
    rng = np.random.default_rng(1)
    arr = (rng.random((16, 24, 3)) * 255).astype(np.uint8)
    jpg = str(tmp_path / "photo.png")
    Image.fromarray(arr).save(jpg, format="JPEG")
    np.testing.assert_array_equal(
        images.load_rgb(jpg), np.asarray(Image.open(jpg).convert("RGB"),
                                         np.float32) / 255)
    pal = str(tmp_path / "pal.png")
    Image.fromarray(arr).convert("P").save(pal)
    np.testing.assert_array_equal(images.load_channel0(pal, (16, 24)),
                                  np.asarray(Image.open(pal)))
    own = str(tmp_path / "own.png")
    images.write_png(own, arr)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="photo.png"):
        images.load_rgb(jpg)
    np.testing.assert_array_equal(images.load_rgb(own), arr / np.float32(255))


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------

RASTERS = ("image", "depth_map", "feat_map", "dynamic_mask", "sky_mask",
           "semantic_mask", "instance_mask", "sam_mask")
MATRICES = ("world_view", "full_proj", "campos")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_cameras_equal(got, want):
    assert len(got) == len(want)
    for t, j in zip(got, want):
        for k in RASTERS:
            a, b = getattr(t, k), getattr(j, k)
            assert (a is None) == (b is None), k
            if a is not None:
                assert a.device.type == "cpu"
                np.testing.assert_array_equal(_np(a), _np(b), err_msg=k)
        for k in MATRICES:
            np.testing.assert_allclose(_np(getattr(t, k)), _np(getattr(j, k)),
                                       rtol=1e-6, atol=0, err_msg=k)
        assert float(t.time) == float(j.time)
        assert (t.fovx, t.fovy) == (float(j.fovx), float(j.fovy))
        assert (t.image_height, t.image_width, t.uid, t.cam_idx,
                t.frame_idx) == (j.image_height, j.image_width, int(j.uid),
                                 int(j.cam_idx), int(j.frame_idx))


def assert_infos_equal(got, want):
    np.testing.assert_array_equal(got.points, want.points)
    np.testing.assert_array_equal(got.colors, want.colors)
    np.testing.assert_array_equal(got.aabb, want.aabb)
    assert got.nerf_radius == want.nerf_radius
    assert got.max_time == want.max_time
    for split in ("train_cameras", "test_cameras", "full_cameras"):
        assert_cameras_equal(getattr(got, split), getattr(want, split))


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    return make_fixture(str(tmp_path_factory.mktemp("waymo")), n_frames=3)


@pytest.fixture(scope="module")
def png_clip(clip, tmp_path_factory):
    """The clip with PNG content under the reader's ``.jpg`` names, plus
    sky masks, SAM masks and DINO feature maps."""
    root = str(tmp_path_factory.mktemp("waymo_png") / "clip")
    shutil.copytree(clip, root)
    rng = np.random.default_rng(5)
    for d in ("sam_masks", "dinov2_vitb14"):
        os.makedirs(os.path.join(root, d))
    for name in sorted(os.listdir(os.path.join(root, "images"))):
        path = os.path.join(root, "images", name)
        rgb = Image.open(path).convert("RGB").resize((288, 192), Image.BILINEAR)
        images.write_png(path, np.asarray(rgb))
        stem = name[:-len(".jpg")]
        sky = np.zeros((320, 480), np.uint8)
        sky[:60 + 10 * rng.integers(0, 5)] = 255
        images.write_png(os.path.join(root, "sky_masks", stem + ".png"), sky)
        sam = rng.integers(0, 7, (60, 90)).astype(np.uint8)
        images.write_png(os.path.join(root, "sam_masks", stem + ".jpg"), sam)
        np.save(os.path.join(root, "dinov2_vitb14", stem + ".npy"),
                rng.normal(size=(1, 8, 12, 16)).astype(np.float32))
    return root


READ_KW = dict(num_pts=300, save_occ_grid=True, recompute_occ_grid=True,
               occ_voxel_size=2.0)


def read_both(path, **kw):
    kw = dict(READ_KW, **kw)
    return (twaymo.read_waymo(path, device="cpu", **kw),
            jwaymo.read_waymo(path, **kw))


def test_read_waymo_jpeg_clip_matches_jax(clip):
    got, want = read_both(clip, load_size=(96, 144), load_panoptic_mask=True)
    assert_infos_equal(got, want)
    np.testing.assert_array_equal(got.occ_grid, want.occ_grid)
    assert got.panoptic_object_ids == want.panoptic_object_ids
    assert got.num_panoptic_objects == want.num_panoptic_objects > 1
    assert got.train_cameras[0].dynamic_mask.any()


def test_read_waymo_png_clip_matches_jax(png_clip):
    """Stored at the load size, so no resize; the masks are resized."""
    got, want = read_both(png_clip, load_size=(192, 288), load_sky_mask=True,
                          load_sam_mask=True, load_feat_map=True)
    assert_infos_equal(got, want)
    cam = got.train_cameras[0]
    assert cam.sky_mask.any() and cam.sam_mask.max() > 0
    assert cam.feat_map.shape == (192, 288, 3)


def test_stride_split_matches_jax(clip):
    got, want = read_both(clip, load_size=(64, 96), stride=2, end_time=2)
    assert [c.frame_idx for c in got.test_cameras] == [2, 2, 2]
    assert len(got.full_cameras) == 9
    assert_infos_equal(got, want)
    got, want = read_both(clip, load_size=(64, 96), stride=2, eval_=False,
                          start_time=1)
    assert not got.test_cameras and len(got.train_cameras) == 6
    assert_infos_equal(got, want)


def test_cameras_json_is_identical(clip, tmp_path):
    got, want = read_both(clip, load_size=(64, 96), stride=2)
    tcameras.write_cameras_json(str(tmp_path / "t.json"), got.test_cameras,
                                got.train_cameras)
    jcameras.write_cameras_json(str(tmp_path / "j.json"), want.test_cameras,
                                want.train_cameras)
    text = (tmp_path / "t.json").read_text()
    assert text == (tmp_path / "j.json").read_text()
    assert len(json.loads(text)) == 9


@pytest.fixture(scope="module")
def blender_scene(tmp_path_factory):
    return make_blender_fixture(str(tmp_path_factory.mktemp("blender")))


@pytest.mark.parametrize("white,eval_", [(True, True), (False, False)])
def test_read_blender_matches_jax(blender_scene, white, eval_):
    got = tblender.read_blender_scene(blender_scene, white, eval_, num_pts=500,
                                      device="cpu")
    want = jblender.read_blender_scene(blender_scene, white, eval_,
                                       num_pts=500)
    assert_infos_equal(got, want)


# a COLMAP sparse model: two cameras, nine images (one file missing), 30
# points, written as text or binary
COLMAP_CAMS = {1: ("PINHOLE", 1, 48, 32, [50.0, 52.0, 24.0, 16.0]),
               2: ("SIMPLE_PINHOLE", 0, 40, 30, [45.0, 20.0, 15.0])}


def write_colmap(root, binary):
    rng = np.random.default_rng(2)
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse)
    os.makedirs(os.path.join(root, "images"))
    imgs = []
    for i in range(9):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        cam = 1 + i % 2
        name = f"view_{8 - i:02d}.png"      # ids and names in opposite order
        imgs.append((i + 1, q, rng.normal(0, 2, 3), cam, name))
        if i != 4:
            w, h = COLMAP_CAMS[cam][2:4]
            Image.fromarray((rng.random((h, w, 3)) * 255).astype(
                np.uint8)).save(os.path.join(root, "images", name))
    xyz = rng.normal(0, 3, (30, 3))
    rgb = rng.integers(0, 256, (30, 3))
    if binary:
        with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
            f.write(struct.pack("<Q", len(COLMAP_CAMS)))
            for cid, (_, mid, w, h, params) in COLMAP_CAMS.items():
                f.write(struct.pack("<iiQQ", cid, mid, w, h))
                f.write(struct.pack(f"<{len(params)}d", *params))
        with open(os.path.join(sparse, "images.bin"), "wb") as f:
            f.write(struct.pack("<Q", len(imgs)))
            for iid, q, t, cam, name in imgs:
                f.write(struct.pack("<i4d3di", iid, *q, *t, cam))
                f.write(name.encode() + b"\x00")
                f.write(struct.pack("<Q", 2) + struct.pack("<ddq", 1, 2, 3) * 2)
        with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
            f.write(struct.pack("<Q", len(xyz)))
            for k, (p, c) in enumerate(zip(xyz, rgb)):
                f.write(struct.pack("<Q3d3Bd", k, *p, *c.tolist(), 0.5))
                f.write(struct.pack("<Q", 3) + struct.pack("<ii", 1, 2) * 3)
    else:
        with open(os.path.join(sparse, "cameras.txt"), "w") as f:
            f.write("# CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
            for cid, (model, _, w, h, params) in COLMAP_CAMS.items():
                f.write(f"{cid} {model} {w} {h} "
                        + " ".join(repr(p) for p in params) + "\n")
        with open(os.path.join(sparse, "images.txt"), "w") as f:
            f.write("# IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
            for iid, q, t, cam, name in imgs:
                f.write(f"{iid} " + " ".join(repr(float(v)) for v in (*q, *t))
                        + f" {cam} {name}\n1.5 2.5 -1 3.0 4.0 7\n")
        with open(os.path.join(sparse, "points3D.txt"), "w") as f:
            for k, (p, c) in enumerate(zip(xyz, rgb)):
                f.write(f"{k} " + " ".join(repr(float(v)) for v in p)
                        + " " + " ".join(str(int(v)) for v in c)
                        + " 0.5 1 2 3 4\n")
    return root


@pytest.mark.parametrize("binary", [False, True], ids=["text", "binary"])
def test_read_colmap_matches_jax(tmp_path, binary):
    root = write_colmap(str(tmp_path / "colmap"), binary)
    got = tcolmap.read_colmap_scene(root, device="cpu")
    want = jcolmap.read_colmap_scene(root)
    assert_infos_equal(got, want)
    assert len(got.test_cameras) == 2 and len(got.points) == 30
    assert sum(c.image is None for c in got.full_cameras) == 1


# ---------------------------------------------------------------------------
# load_scene
# ---------------------------------------------------------------------------

def test_next_pow2_matches_jax():
    for n in (1, 2, 3, 4, 5, 1000, 65535, 65536, 65537, 1 << 21, 3_000_000):
        assert tscene.next_pow2(n) == jscene.next_pow2(n)


@pytest.fixture(scope="module")
def scenes(clip, blender_scene, tmp_path_factory):
    return {"waymo": clip, "blender": blender_scene,
            "colmap": write_colmap(str(tmp_path_factory.mktemp("c") / "m"),
                                   binary=True)}


@pytest.mark.parametrize("kind,capacity,want_cap", [
    ("waymo", None, 1 << 16),        # 1.5 x 300 points: clamped up to 2^16
    ("waymo", 4096, 4096),
    ("colmap", None, 1 << 16),
    ("blender", None, 1 << 18),      # 100,000 random points: next_pow2(1.5 n)
])
def test_load_scene_dispatch_and_capacity(scenes, kind, capacity, want_cap):
    kw = dict(source_path=scenes[kind], num_pts=300, load_h=64, load_w=96,
              white_background=True)
    got = tscene.load_scene(TMP(**kw), pool_capacity=capacity, device="cpu")
    want = jscene.load_scene(JMP(**kw), pool_capacity=capacity)
    assert got.pool.capacity == want.pool.capacity == want_cap
    assert got.cameras_extent == want.cameras_extent
    np.testing.assert_array_equal(got.aabb.numpy(), np.asarray(want.aabb))
    assert (got.aabb[0] >= got.aabb[1]).all()            # [max; min]
    np.testing.assert_array_equal(got.pool.alive.numpy(),
                                  np.asarray(want.pool.alive))
    for f in ("xyz", "features_dc", "opacity", "rotation"):
        np.testing.assert_array_equal(getattr(got.pool, f).numpy(),
                                      np.asarray(getattr(want.pool, f)),
                                      err_msg=f)
    np.testing.assert_allclose(got.pool.scaling.numpy(),
                               np.asarray(want.pool.scaling), rtol=1e-6)
    assert len(got.get_train_cameras()) == len(want.get_train_cameras())


def test_load_scene_refuses_an_unknown_layout(tmp_path):
    with pytest.raises(ValueError, match="scene type"):
        tscene.load_scene(TMP(source_path=str(tmp_path)), device="cpu")
