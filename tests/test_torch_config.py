"""The port's config: a faithful copy of the JAX package's, plus ``CUDA``."""

import test_torch_workers  # noqa: F401  (first: sizes this xdist worker's thread pools)

import glob
import os

import numpy as np
import pytest

from feature_intertwiner_tpu.config import build_config as jax_build_config
from feature_intertwiner_tpu_torch.config import FLAGSHIP_OVERRIDES, Config, build_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP_YAML = os.path.join(ROOT, "configs", "105", "meta_105_quick_1.yaml")


def test_flagship_overrides_equal_the_yaml():
    from_yaml = build_config(config_file=FLAGSHIP_YAML, phase="inference").to_dict()
    from_opts = build_config("meta_105_quick_1", "inference",
                             opts=list(FLAGSHIP_OVERRIDES)).to_dict()
    assert from_opts == from_yaml
    assert from_opts["DEV"]["SWITCH"] is True
    assert from_opts["DEV"]["UPSAMPLE_FAC"] == 1.0
    assert from_opts["MODEL"]["BACKBONE"] == "resnet101"


@pytest.mark.parametrize("yaml_file", sorted(glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"),
                                                       recursive=True)))
def test_every_repo_yaml_matches_the_jax_config(yaml_file):
    """Same defaults, same merge: the port's tree is the JAX tree plus CUDA."""
    got = build_config(config_file=yaml_file).to_dict()
    want = jax_build_config(config_file=yaml_file).to_dict()
    assert got.pop("CUDA") == {}
    assert got == want


def test_unknown_keys_are_rejected(tmp_path):
    cfg = Config()
    with pytest.raises(KeyError):
        cfg.merge_from_list(["DEV.NOT_A_KEY", "1"])
    with pytest.raises(KeyError):
        cfg.merge_from_list(["NOPE.KEY", "1"])
    bad = tmp_path / "bad.yaml"
    bad.write_text("CUDA:\n  TYPO: 1\n")
    with pytest.raises(KeyError):
        Config().merge_from_file(str(bad))


def test_cuda_and_tpu_namespaces_parse(tmp_path):
    p = tmp_path / "cfg.yaml"
    p.write_text("CUDA: {}\nTPU:\n  ROI_WINDOW_KERNEL: false\n  ROI_WINDOW_SIZE: 64\n")
    cfg = Config()
    cfg.merge_from_file(str(p))
    cfg.merge_from_list(["TPU.REMAT_BACKBONE", "False", "TPU.MESH_DATA", "4"])
    cfg.finalize()
    assert cfg.CUDA == {}
    assert cfg.TPU.ROI_WINDOW_KERNEL is False and cfg.TPU.ROI_WINDOW_SIZE == 64
    np.testing.assert_array_equal(cfg.MODEL.BACKBONE_SHAPES[0], [256, 256])
