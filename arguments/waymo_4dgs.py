# 4DGaussians' full-attribute deformation decoder on a Waymo clip: the
# ModelHiddenParams of 4DGaussians' N3V ("dynerf") preset,
# arguments/dynerf/default.py (G. Wu et al., CVPR 2024,
# https://github.com/hustvl/4DGaussians), over nvs.py's settings.  Every
# head deforms its attribute (dx, ds, dr, do, dshs; 4DGaussians' default
# apply_rotation=False adds dr to the rotation), each ReLU -> Linear(128,
# 128) -> ReLU -> Linear(128, out) after feature_out = Linear(32, 128)
# (defor_depth 0).  The hexplane has 16 channels at two scales over 150
# time rows, N3V's 300-frame clips; a Waymo clip has fewer frames.
# 4DGaussians has no DINO feature head, so feat_head is off and the
# feature loss with it.
ModelParams = dict(
    stride=10,
)
ModelHiddenParams = dict(
    kplanes_config={
        "grid_dimensions": 2,
        "input_coordinate_dim": 4,
        "output_coordinate_dim": 16,
        "resolution": [64, 64, 64, 150],
    },
    multires=[1, 2],
    defor_depth=0,
    net_width=128,
    plane_tv_weight=0.0002,
    time_smoothness_weight=0.001,
    l1_time_planes=0.0001,
    no_dx=False,
    no_ds=False,
    no_dr=False,
    no_do=False,
    no_dshs=False,
    apply_rotation=False,
    empty_voxel=False,
    static_mlp=False,
    feat_head=False,
)
