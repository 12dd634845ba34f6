# Deformable 3D Gaussians' deformation network on a Waymo clip (Z. Yang et
# al., CVPR 2024, https://github.com/ingra14m/Deformable-3D-Gaussians,
# utils/time_utils.py::DeformNetwork outside Blender scenes, not 6-DoF):
# 8 Linear(., 256) + ReLU on the positional encodings of the detached
# position (10 octaves, 63 inputs) and of the time (10 octaves, 21), the
# encodings concatenated again after the fifth layer, and three heads
# whose position, scaling and rotation deltas are added after activation
# (models/deform_mlp.py).  waymo_4dgs.py's clip settings; the field has no
# grid, so the hexplane weights are 0, and no DINO head (feat_head off,
# with the feature loss).  Opacity and SH are not deformed.  The loss and
# learning rates stay S3Gaussian's (L1, D-SSIM, depth, the dx term on the
# position delta).  The JAX package has no such field: it reads the shared
# groups of this file and ignores FieldParams.
ModelParams = dict(
    stride=10,
)
ModelHiddenParams = dict(
    no_dx=False,
    no_ds=True,
    no_dr=True,
    no_do=True,
    no_dshs=True,
    feat_head=False,
    plane_tv_weight=0.0,
    time_smoothness_weight=0.0,
    l1_time_planes=0.0,
)
FieldParams = dict(
    field_kind="deformable3dgs",
    field_depth=8,
    field_width=256,
    field_multires=10,
    field_t_multires=10,
    field_skip=4,
)
