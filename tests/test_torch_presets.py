"""``arguments/nvs.py`` and ``arguments/static_nvs.py`` through the port's
training CLI against ``train.py``, both on the CPU, on the fabricated
Waymo clip with the same argv and the same initial field
(``tests/torch_cli_pairs.py``).

Each preset is merged with the tiny hexplane and nothing else changed:
both keep the preset's stride 10, so the clip has 11 frames and frame
10's three cameras are held out.  Overrides in the merged files: none
but the tiny hexplane; the cadence (3 coarse + 6 fine steps, the first
densify at fine step 4, a pool of 4096 rows) comes from the flags, which
neither preset sets.

Held for each: the losses up to the first densify (rtol 1e-4) and its
counts, the logger's keys, ``cameras.json``, the ``cfg_args`` fields
with the preset's stride and ``no_dx``, and the final sweep's splits
(a ``test`` split of frame 10), metric keys and frame files.  With
``static_nvs`` the port's field has no position head, its checkpoint no
``deform.heads.pos.*`` and neither sweep writes flow frames or the
dynamic/static PLY split.
"""

import os

import pytest
import torch

from torch_cli_pairs import (FINE, check_cameras, check_cfg_args,
                             check_logger, check_losses, check_sweep,
                             merged_preset, run_pair)
from waymo_fixture import make_fixture
from torch_threads import one_torch_thread  # noqa: F401

PRESETS = ("nvs.py", "static_nvs.py")
N_FRAMES, STRIDE = 11, 10
FLOWS = {"forward_flows", "backward_flows"}


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    return make_fixture(str(tmp_path_factory.mktemp("clip") / "clip"),
                        n_frames=N_FRAMES)


@pytest.fixture(scope="module", params=PRESETS)
def pair(request, clip, tmp_path_factory):
    """(preset, the preset's own groups, jax out, port out, port state,
    printed outputs) of one preset's pair of runs."""
    root = tmp_path_factory.mktemp(request.param[:-3])
    config, preset = merged_preset(root, request.param)
    assert preset["ModelParams"]["stride"] == STRIDE
    return (request.param, preset) + run_pair(root, clip, config)


def test_losses_match_up_to_the_first_densify(pair):
    check_losses(*pair[2:4])


def test_logger_keys_match(pair):
    log = check_logger(*pair[2:4])
    # the logger has no dx entry in either stage, whatever the preset
    assert not any("dx" in k for line in log for k in line)


def test_cameras_json_is_identical_and_holds_frame_10_out(pair):
    cams = check_cameras(*pair[2:4])
    # cameras.json lists the test cameras first: frame 10's three
    assert len(cams) == 3 * N_FRAMES
    assert [c["img_name"][:3] for c in cams[:3]] == ["010"] * 3


def test_cfg_args_hold_the_preset(pair):
    name, preset = pair[:2]
    cfg = check_cfg_args(*pair[2:4])
    assert cfg["stride"] == STRIDE
    assert cfg["no_dx"] is (name == "static_nvs.py")
    assert cfg["net_width"] == 16            # the tiny hexplane was merged
    for k, v in preset.get("ModelHiddenParams", {}).items():
        assert cfg[k] == v, k


def test_sweep_splits_metrics_and_frames_match(pair):
    name = pair[0]
    found = check_sweep(*pair[2:4])
    assert set(found) == {"test", "train", "full"}
    # the test split is frame 10: one timestamp, no flow renders
    assert all(f.endswith("_000.png") for f in found["test"][1])
    flows = {f.rsplit("_", 1)[0] for _, frames in found.values()
             for f in frames} & FLOWS
    assert flows == (set() if name == "static_nvs.py" else FLOWS)
    for out in pair[2:4]:
        assert not os.path.exists(os.path.join(out, "eval", "pcd"))


def test_static_nvs_field_has_no_position_head(pair):
    name, _, _, tout, state, _ = pair
    flat = torch.load(os.path.join(tout, f"chkpnt_fine_{FINE}", "state.pt"),
                      weights_only=True)
    pos = [k for k in flat if k.startswith("deform.heads.pos.")]
    if name == "static_nvs.py":
        assert not pos and "pos" not in state.deform.heads
    else:
        assert pos and "pos" in state.deform.heads
