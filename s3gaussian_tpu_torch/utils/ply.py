"""Binary little-endian PLY I/O in the Inria 3DGS attribute layout (a copy
of ``s3gaussian_tpu/utils/ply.py``: numpy only, byte for byte the same
files).

Parity: ``save_ply`` / ``load_ply`` (gaussian_model.py:258-275, 355-395):
properties x,y,z, nx,ny,nz, f_dc_0..2, f_rest_0..44, opacity, scale_0..2,
rot_0..3.  plyfile is not in this image, so the (tiny) format is written
directly with numpy structured arrays.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def write_ply(path: str, fields: List[Tuple[str, np.ndarray]]) -> None:
    """fields: ordered (name, [N] float32 column)."""
    n = len(fields[0][1])
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    header += [f"property float {name}" for name, _ in fields]
    header += ["end_header", ""]
    dtype = np.dtype([(name, "<f4") for name, _ in fields])
    data = np.empty(n, dtype=dtype)
    for name, col in fields:
        data[name] = np.asarray(col, np.float32)
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(data.tobytes())


def read_ply(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        raw = f.read()
    end = raw.index(b"end_header\n") + len(b"end_header\n")
    header = raw[:end].decode("ascii").splitlines()
    if header[0].strip() != "ply":
        raise ValueError(f"{path} is not a PLY file")
    fmt = header[1].split()[1]
    n = 0
    props: List[Tuple[str, str]] = []
    for line in header:
        parts = line.split()
        if parts[:2] == ["element", "vertex"]:
            n = int(parts[2])
        elif parts and parts[0] == "property":
            props.append((parts[2], parts[1]))
    typemap = {"float": "f4", "float32": "f4", "double": "f8",
               "uchar": "u1", "int": "i4", "uint": "u4"}
    endian = "<" if fmt == "binary_little_endian" else ">"
    dtype = np.dtype([(name, endian + typemap[t]) for name, t in props])
    data = np.frombuffer(raw[end:end + n * dtype.itemsize], dtype=dtype)
    return {name: np.array(data[name]) for name, _ in props}


def gaussian_ply_fields(xyz: np.ndarray, f_dc: np.ndarray, f_rest: np.ndarray,
                        opacity: np.ndarray, scaling: np.ndarray,
                        rotation: np.ndarray) -> List[Tuple[str, np.ndarray]]:
    """Inria layout: f_dc stored channel-major from [N,1,3]; f_rest
    flattened from [N,15,3] transposed to [N,3,15] (the reference stores
    ``transpose(1,2).flatten`` of its [N, K, 3] tensors,
    gaussian_model.py:262-264)."""
    n = xyz.shape[0]
    fields = [("x", xyz[:, 0]), ("y", xyz[:, 1]), ("z", xyz[:, 2]),
              ("nx", np.zeros(n)), ("ny", np.zeros(n)), ("nz", np.zeros(n))]
    dc = f_dc.reshape(n, -1, 3).transpose(0, 2, 1).reshape(n, -1)
    for i in range(dc.shape[1]):
        fields.append((f"f_dc_{i}", dc[:, i]))
    fr = f_rest.reshape(n, -1, 3).transpose(0, 2, 1).reshape(n, -1)
    for i in range(fr.shape[1]):
        fields.append((f"f_rest_{i}", fr[:, i]))
    fields.append(("opacity", opacity.reshape(n)))
    for i in range(scaling.shape[1]):
        fields.append((f"scale_{i}", scaling[:, i]))
    for i in range(rotation.shape[1]):
        fields.append((f"rot_{i}", rotation[:, i]))
    return fields


def parse_gaussian_ply(d: Dict[str, np.ndarray], max_sh_degree: int = 3):
    """Inverse of gaussian_ply_fields (load_ply, gaussian_model.py:355-395)."""
    xyz = np.stack([d["x"], d["y"], d["z"]], 1)
    n = len(xyz)
    f_dc = np.stack([d["f_dc_0"], d["f_dc_1"], d["f_dc_2"]], 1)[:, None, :]
    k = (max_sh_degree + 1) ** 2 - 1
    rest_names = sorted((nm for nm in d if nm.startswith("f_rest_")),
                        key=lambda s: int(s.split("_")[-1]))
    fr = np.stack([d[nm] for nm in rest_names], 1)
    f_rest = fr.reshape(n, 3, k).transpose(0, 2, 1)
    opacity = d["opacity"][:, None]
    scale_names = sorted((nm for nm in d if nm.startswith("scale_")),
                         key=lambda s: int(s.split("_")[-1]))
    scaling = np.stack([d[nm] for nm in scale_names], 1)
    rot_names = sorted((nm for nm in d if nm.startswith("rot_")),
                       key=lambda s: int(s.split("_")[-1]))
    rotation = np.stack([d[nm] for nm in rot_names], 1)
    return xyz, f_dc, f_rest, opacity, scaling, rotation
