"""Configuration dataclasses of the port, and the CLI reflection over them.

Copies of the groups of ``s3gaussian_tpu/config.py``, with the same field
names and defaults (a CPU test holds every field against the JAX
package's), so a config written for one package configures the other.
Fields that only steer the TPU build are left out:
``ModelHiddenParams.remat_deform`` and ``RasterConfig``'s
``max_pairs_per_tile`` (the jnp oracle's cap), ``use_pallas``,
``sort_bf16``, ``sort_hier``, ``multicam_serialize`` and
``multicam_scan``.  Their flags are unknown to the port's CLI, and a
config file that sets them has those keys ignored, as it has any key a
group does not know.

``add_group_args``/``extract_group`` turn a group into CLI flags and back
with the reference's quirks: every bool is ``store_true`` (so a field
that defaults to True, such as ``render_process``, cannot be switched off
from the command line, only from a config file), and the shorthand
fields also get ``-<first letter>``.  ``apply_config_file`` execs a
reference-style Python config that assigns ``<GroupName> = dict(...)``.

``FieldParams`` is the port's own group, which the JAX package lacks:
which deformation field a run trains (the hexplane field of
``ModelHiddenParams``, or Deformable 3D Gaussians' MLP at its widths).
Its flags, its dict in a config file and its fields in ``cfg_args`` sit
beside those of the shared groups (``GROUPS``); a config or
``cfg_args`` without them trains the hexplane field.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class ModelParams:
    """Data and scene loading options (reference ``ModelParams``)."""

    debug_test: bool = False
    sh_degree: int = 3
    # explicit pool capacity; 0 = next_pow2(1.5x the init count)
    pool_capacity: int = 0
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    data_device: str = "tpu"
    eval: bool = True
    # test/train split
    stride: int = 0
    # training snapshots
    render_process: bool = True
    # waymo clip time range
    start_time: int = 0
    end_time: int = 49
    original_start_time: int = 0
    num_objs: int = 256
    num_pts: int = 1500000
    # mask loading options
    load_sky_mask: bool = False
    load_panoptic_mask: bool = False
    load_sam_mask: bool = False
    load_dynamic_mask: bool = True
    load_feat_map: bool = True
    # waymo
    n_views: int = 100
    random_init: bool = False
    train_split: bool = False
    num_classes: int = 200
    load_intrinsic: bool = False
    load_c2w: bool = False
    # image load size (the reference hardcodes 640x960)
    load_h: int = 640
    load_w: int = 960
    # occupancy grid
    save_occ_grid: bool = True
    occ_voxel_size: float = 0.4
    recompute_occ_grid: bool = False

    _shorthand = ("source_path", "model_path", "images", "resolution",
                  "white_background")
    __hash__ = object.__hash__


@dataclass
class PipelineParams:
    """Render-pipeline toggles (reference ``PipelineParams``)."""

    convert_SHs_python: bool = True
    compute_cov3D_python: bool = False
    debug: bool = False

    __hash__ = object.__hash__


@dataclass
class OptimizationParams:
    """Optimizer, schedule and density-control knobs (reference
    ``OptimizationParams``)."""

    vis_step: int = 2000
    batch_size: int = 1
    # rig batching: N same-timestep cameras in one optimizer step
    multicam: int = 0
    multicam_lr_scale: float = 1.0
    multicam_percam_stats: int = 1

    iterations: int = 50_000
    coarse_iterations: int = 5000

    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000

    deformation_lr_init: float = 0.000016
    deformation_lr_final: float = 0.0000016
    deformation_lr_delay_mult: float = 0.01
    grid_lr_init: float = 0.00016
    grid_lr_final: float = 0.000016

    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    size_prune_cap: float = 0.0
    prune_after_densify: int = 0
    lambda_dssim: float = 0.2
    lambda_depth: float = 0.5
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    pruning_interval: int = 100
    pruning_from_iter: int = 500
    densify_until_iter: int = 25_000
    densify_grad_threshold_coarse: float = 0.0002
    densify_grad_threshold_fine_init: float = 0.0002
    densify_grad_threshold_after: float = 0.0002

    opacity_threshold_coarse: float = 0.005
    opacity_threshold_fine_init: float = 0.005
    opacity_threshold_fine_after: float = 0.005

    random_background: bool = False
    max_points: int = 500_000
    prune_from_iter: int = 500
    prune_interval: int = 100

    scale_ratio: float = 1.0
    include_feature: bool = True
    language_feature_lr: float = 0.0025
    feat_dim: int = 8
    feat_conv_lr: float = 0.0001

    lambda_feat: float = 0.001
    dx_reg: bool = False
    lambda_dx: float = 0.001
    lambda_dshs: float = 0.001

    custom_xyz_scheduler: bool = False

    # deprecated in the reference but kept for config compatibility
    densify_from_iter: int = 500
    position_lr_after_iter: int = 500
    scale_ratio_threshold: float = 5.0
    hard_alpha_composite: bool = True
    alpha_mask_threshold: float = 0.8

    __hash__ = object.__hash__


@dataclass
class ModelHiddenParams:
    """Deformation-field hyperparameters (reference ``ModelHiddenParams``)."""

    net_width: int = 64
    timebase_pe: int = 4
    defor_depth: int = 1
    posebase_pe: int = 10
    scale_rotation_pe: int = 2
    opacity_pe: int = 2
    timenet_width: int = 64
    timenet_output: int = 32
    bounds: float = 1.6
    plane_tv_weight: float = 0.0001
    time_smoothness_weight: float = 0.01
    l1_time_planes: float = 0.0001
    kplanes_config: Dict[str, Any] = field(default_factory=lambda: {
        "grid_dimensions": 2,
        "input_coordinate_dim": 4,
        "output_coordinate_dim": 32,
        "resolution": [64, 64, 64, 25],
    })
    multires: List[int] = field(default_factory=lambda: [1, 2, 4, 8])
    no_dx: bool = False
    no_grid: bool = False
    no_ds: bool = True
    no_dr: bool = True
    no_do: bool = True
    no_dshs: bool = False
    feat_head: bool = True
    empty_voxel: bool = False
    grid_pe: int = 0
    static_mlp: bool = False
    apply_rotation: bool = False
    # hexplane gathers and products in bfloat16 (master planes stay f32)
    grid_compute_bf16: bool = True

    __hash__ = object.__hash__


@dataclass
class FieldParams:
    """The deformation field a run trains (port only).  ``hexplane``:
    ``models/deformation.py``, sized by ``ModelHiddenParams``.
    ``deformable3dgs``: ``models/deform_mlp.py``, Deformable 3D
    Gaussians' ``DeformNetwork`` (Yang et al., CVPR 2024) at the widths
    below: ``field_depth`` Linear layers of ``field_width`` on the
    positional encodings of the position (``field_multires`` octaves)
    and time (``field_t_multires``), the encodings concatenated again
    after layer ``field_skip``."""

    field_kind: str = "hexplane"
    field_depth: int = 8
    field_width: int = 256
    field_multires: int = 10
    field_t_multires: int = 10
    field_skip: int = 4

    __hash__ = object.__hash__


@dataclass
class RasterConfig:
    """Static capacities of the rasterizer (no reference analog: they
    replace the CUDA reference's dynamically sized buffers)."""

    tile_x: int = 16
    tile_y: int = 16
    max_visible: int = 1 << 19   # render budget NR
    rect_w: int = 4              # per-gaussian tile-rect cap, tiles
    rect_h: int = 4
    pair_budget: int = 1 << 21   # cap on sorted pairs fed to the compositor
    chunk: int = 128
    cull_before_deform: bool = False
    cull_margin_px: float = 32.0
    # tile rects cut to the alpha >= 1/255 ellipse (ops/project.py)
    tight_rect: bool = True
    # two-class pair emission: the periphery slots of this many bigs
    big_budget: int = 0

    __hash__ = object.__hash__

    @property
    def rect_cap(self) -> int:
        return self.rect_w * self.rect_h

    def n_pair_slots(self, nr: int) -> int:
        """Length M of the pair-slot stream for an NR-slot render set."""
        if self.big_budget <= 0:
            return nr * self.rect_cap
        nb = min(self.big_budget, nr)
        return 4 * nr + (self.rect_cap - 4) * nb

    @property
    def max_pairs(self) -> int:
        return self.max_visible * self.rect_cap


# ---------------------------------------------------------------------------
# argparse reflection (reference arguments/__init__.py:19-45)
# ---------------------------------------------------------------------------

def add_group_args(parser: argparse.ArgumentParser, cls, name: str) -> None:
    """Register a dataclass's fields as CLI flags: bools ``store_true``,
    int/float/str typed, dict/list fields config-file only, shorthand
    fields also ``-<first letter>``."""
    group = parser.add_argument_group(name)
    shorthand = getattr(cls, "_shorthand", ())
    for f in dataclasses.fields(cls):
        if f.name.startswith("_"):
            continue
        default = f.default if f.default is not dataclasses.MISSING else None
        if f.default_factory is not dataclasses.MISSING:  # type: ignore
            default = f.default_factory()  # type: ignore
        flags = ["--" + f.name]
        if f.name in shorthand:
            flags.append("-" + f.name[0])
        if f.type in (bool, "bool"):
            group.add_argument(*flags, default=default, action="store_true")
        elif f.type in (int, "int", float, "float", str, "str"):
            kind = {"int": int, "float": float, "str": str}.get(f.type, f.type)
            group.add_argument(*flags, default=default, type=kind)


def extract_group(cls, args: argparse.Namespace):
    """A dataclass instance from parsed args (fields without a flag keep
    their defaults); ``source_path`` made absolute."""
    inst = cls(**{f.name: getattr(args, f.name)
                  for f in dataclasses.fields(cls)
                  if not f.name.startswith("_") and hasattr(args, f.name)})
    if isinstance(inst, ModelParams) and inst.source_path:
        inst.source_path = os.path.abspath(inst.source_path)
    return inst


# the groups the JAX package has too, and the port's own
GROUPS = ("ModelParams", "PipelineParams", "OptimizationParams",
          "ModelHiddenParams", "RasterConfig")
PORT_GROUPS = ("FieldParams",)


def load_config_overrides(path: str, groups: Tuple[str, ...] = GROUPS
                          ) -> Dict[str, Dict[str, Any]]:
    """Exec a reference-style config file (``arguments/nvs.py`` etc.) that
    assigns ``<GroupName> = dict(...)``; returns the dicts of ``groups``
    by group."""
    scope: Dict[str, Any] = {}
    with open(path) as f:
        code = f.read()
    exec(compile(code, path, "exec"), scope)  # noqa: S102 - trusted local file
    return {name: scope[name] for name in groups
            if isinstance(scope.get(name), dict)}


def merge_hparams(group, overrides: Dict[str, Any]):
    """Set the keys of ``overrides`` that ``group`` has; others are
    ignored (reference utils/params_utils.py:1-9)."""
    for k, v in overrides.items():
        if hasattr(group, k):
            setattr(group, k, v)
    return group


def apply_config_file(path: str, model: ModelParams, pipe: PipelineParams,
                      opt: OptimizationParams, hyper: ModelHiddenParams,
                      cfg: Optional[RasterConfig] = None,
                      field: Optional[FieldParams] = None):
    ov = load_config_overrides(path, GROUPS + PORT_GROUPS)
    merge_hparams(model, ov.get("ModelParams", {}))
    merge_hparams(pipe, ov.get("PipelineParams", {}))
    merge_hparams(opt, ov.get("OptimizationParams", {}))
    merge_hparams(hyper, ov.get("ModelHiddenParams", {}))
    if cfg is not None:
        merge_hparams(cfg, ov.get("RasterConfig", {}))
    if field is not None:
        merge_hparams(field, ov.get("FieldParams", {}))
    return model, pipe, opt, hyper
