"""The benchmark's yardstick of work: the H100's peaks, and the
floating-point operations and bytes that a fine train step requires,
counted from shapes and from the compositors' work counts.

Conventions, everywhere: an FMA is two operations; a transcendental
(exp, sqrt, division) one; compares and selects none.  Bytes count each
input read once and each output written once.  The counts are of the
arithmetic the step's mathematics needs, not of what the program issues,
so they bound the program's work from below.

Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W limit: 67 TFLOP/s
float32 outside the tensor cores, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

from typing import Dict, Sequence

from benchmark.frozen import work_counts as wc

F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def least_s(flops: float, n_bytes: float) -> float:
    """The least time the card can take for ``flops`` and ``n_bytes``."""
    return max(flops / F32_FLOPS, n_bytes / HBM_BYTES_PER_S)


def linear(n_in: int, n_out: int) -> int:
    """Operations of one row through ``Linear(n_in, n_out)``."""
    return 2 * n_in * n_out + n_out


def field_forward(model: Dict) -> int:
    """Operations of one row through the deformation field's forward:
    the aabb normalisation, the hexplane's planes at every scale
    (bilinear spatial planes: 4 corner weights then 7 a channel; the time
    planes at one time: a 1-D lerp, 3 a channel; the product of the six
    planes, 5 a channel), ``feature_out``, the heads that are on (pos,
    shs) and the DINO head."""
    c = model["kplanes_config"]["output_coordinate_dim"]
    n_scales = len(model["multires"])
    w = model["net_width"]
    grid = 6 + n_scales * (3 * (8 + 7 * c) + 3 * (2 + 3 * c) + 5 * c)
    mlp = linear(c * n_scales, w) + (model["defor_depth"] - 1) * linear(w, w)
    heads = []
    if not model["no_dx"]:
        heads.append(3)
    if not model["no_ds"]:
        heads.append(3)
    if not model["no_dr"]:
        heads.append(4)
    if not model["no_do"]:
        heads.append(1)
    if not model["no_dshs"]:
        heads.append(48)
    mlp += sum(linear(w, w) + linear(w, o) + 3 for o in heads)
    if model["feat_head"]:
        mlp += linear(w, 64) + linear(64, 64) + linear(64, 3)
    return grid + mlp + 3 + 48


# one row's projection: the 3-D covariance from scale and quaternion
# (~60), the EWA projection to a 2-D conic and its radius (~90), the
# view direction and SH colours at degree 3 (16 basis terms, 3 channels:
# ~140) and the activations (~10)
PROJECT_SH = 300
# one pixel's loss: L1 (9), the SSIM of 3 channels (5 blurred maps, each
# two 11-tap passes: 5 x 2 x 22 = 220 a channel, plus ~20 for the
# formula), the depth term (~10) and the feature L2 (9)
LOSS_PER_PIXEL = 9 + 3 * 240 + 10 + 9
# one Adam update of one parameter: two moments (5), bias corrections
# (2), sqrt, add, divide, multiply by the rate, subtract (5)
ADAM_PER_PARAM = 12
# a backward takes about two forwards' operations (an input and a
# weight product for each matmul, a product per term for the rest)
BACKWARD = 2


def compositor(counts: Dict, backward: bool) -> int:
    """Operations of one compositor pass over one view from the frozen
    work counts ``evaluated``, ``contributing``, ``column_evaluating``
    and ``column_contributing`` (chip_smoke.py:3623-3640)."""
    ops = (counts["column_evaluating"] * wc.COLUMN_OPS
           + counts["evaluated"] * wc.ALPHA_OPS)
    if backward:
        return (ops + counts["contributing"] * (wc.BWD_BLEND_OPS
                                                + wc.BWD_BLEND_FMAS)
                + counts["column_contributing"] * wc.BWD_COLUMN_OPS)
    return ops + counts["contributing"] * (wc.FWD_BLEND_OPS
                                           + wc.FWD_BLEND_FMAS)


def compositor_bytes(counts: Dict, n_tiles: int, pixels: int, m_slots: int,
                     backward: bool) -> int:
    """Bytes of one compositor pass (chip_smoke.py:3633-3640): the pairs
    the tiles read (10 float32 rows each) and the tile ranges; the
    forward writes 8 rows a pixel; the backward reads 5 rows of the output
    and 5 of its cotangent a pixel and writes 16 rows a pair slot."""
    stream = counts["needed"] * 10 * 4 + (n_tiles + 1) * 4
    if backward:
        return stream + 2 * n_tiles * 5 * pixels * 4 + 16 * m_slots * 4
    return stream + n_tiles * 8 * pixels * 4


def segment_sum_bytes(calls: Sequence[tuple]) -> int:
    """Bytes of the field's ordered sums, one step's calls of
    ``segment_sum(keys [K], vals [K, D], n_rows)``: each value and its
    permutation entry read once (float32, int64), each range's offset
    read once and each sum written once."""
    return sum(k * d * 4 + k * 8 + (n + 1) * 8 + n * d * 4
               for k, d, n in calls)


def train_step(model: Dict, field_rows: int, projected_rows: int,
               pixels: int, n_params: int, passes: Sequence[Dict],
               grid_params: int) -> int:
    """Operations one fine train step requires: the field forward and
    backward over ``field_rows`` rows, projection and SH of
    ``projected_rows`` rows forward and backward, each compositor pass of
    ``passes`` (work counts) forward and backward, the loss over
    ``pixels`` pixels forward and backward, the hexplane regularisers
    (~8 an element of ``grid_params``, forward and backward) and Adam
    over ``n_params`` parameters."""
    ops = (1 + BACKWARD) * (field_rows * field_forward(model)
                            + projected_rows * PROJECT_SH
                            + pixels * LOSS_PER_PIXEL
                            + grid_params * 8)
    ops += sum(compositor(p, False) + compositor(p, True) for p in passes)
    return ops + n_params * ADAM_PER_PARAM
