"""The port stands alone: no JAX, no flax, no OpenCV, no PIL, nothing of
the JAX package; PyYAML, matplotlib and h5py only inside the functions
that need them (the card's machine may lack them); and its entry points run
on the GPU unless the caller asks for the CPU."""

import test_torch_workers  # noqa: F401  (first: sizes this xdist worker's thread pools)

import ast
import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "feature_intertwiner_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "cv2", "PIL", "feature_intertwiner_tpu")

SCRIPT = r"""
import importlib
import pkgutil
import sys
import numpy as np
import feature_intertwiner_tpu_torch as port
names = [mod.name for mod in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
for name in ("evaluation.rle", "evaluation.coco", "evaluation.cocoeval", "ops.window_sum",
             "tools.profile_roi", "train.workflow", "main"):
    assert port.__name__ + "." + name in names, name
# importing builds nothing: the RLE library is compiled at first use
assert sys.modules["feature_intertwiner_tpu_torch.evaluation.rle"]._lib is None
from feature_intertwiner_tpu_torch.config import FLAGSHIP_OVERRIDES, build_config

cfg = build_config(opts=list(FLAGSHIP_OVERRIDES) + [
    "MODEL.BACKBONE", "resnet50", "DATASET.NUM_CLASSES", "8",
    "DATA.IMAGE_MIN_DIM", "48", "DATA.IMAGE_MAX_DIM", "64",
    "RPN.ANCHOR_SCALES", "(8, 16, 32, 64, 128)", "RPN.PRE_NMS_LIMIT", "100",
    "RPN.POST_NMS_ROIS_INFERENCE", "16", "TEST.DET_MAX_INSTANCES", "4"])
model = port.build_model(cfg, device="cpu", seed=0)
images = [np.random.RandomState(0).randint(0, 256, (40, 60, 3)).astype(np.uint8)]
out = port.detect(model, images, cfg)
assert len(out) == 1 and set(out[0]) == {"rois", "class_ids", "scores", "masks"}
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "cv2", "PIL", "yaml", "matplotlib",
                                    "h5py")
             or m == "feature_intertwiner_tpu" or m.startswith("feature_intertwiner_tpu."))
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""


def test_import_and_cpu_forward_load_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def _imports(path):
    """(module name, at module level?) for every import in a file."""
    tree = ast.parse(open(path).read(), path)
    top = {id(n) for n in tree.body}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, id(node) in top
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, id(node) in top


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(PORT, "**", "*.py"), recursive=True))
                         + [os.path.join(ROOT, "chip_smoke.py")])
def test_sources_import_nothing_forbidden(path):
    for name, top_level in _imports(path):
        root = name.split(".")[0]
        assert root not in FORBIDDEN, f"{path} imports {name}"
        if root in ("yaml", "matplotlib", "h5py"):
            assert not top_level, f"{path} imports {root} at module level"


def test_entry_points_default_to_the_gpu(monkeypatch):
    from feature_intertwiner_tpu_torch import build_model
    from feature_intertwiner_tpu_torch.config import build_config
    from feature_intertwiner_tpu_torch.inference import mold_inputs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = build_config()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mold_inputs([np.zeros((8, 8, 3), np.uint8)], cfg)
    from feature_intertwiner_tpu_torch.tools import profile_roi
    for sweep in (profile_roi.crop, profile_roi.stage, profile_roi.window):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            sweep(batch=1, boxes=1, size=32)
    from feature_intertwiner_tpu_torch.utils.tsne import tsne_embed
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsne_embed(np.random.RandomState(0).randn(4, 3))
