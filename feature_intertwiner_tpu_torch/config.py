"""Hierarchical configuration, a copy of ``feature_intertwiner_tpu/config.py``.

The port keeps its own copy (it imports nothing of the JAX package): the same
namespaces, option names and defaults, YAML overlay with strict unknown-key
rejection and type coercion, trailing ``KEY.SUBKEY VALUE`` overrides, and the
derived values of :meth:`Config.finalize`.

Differences from the JAX copy:

- a ``CUDA`` namespace for the port's own options, added to the tree before
  any merge (the merge rejects unknown keys);
- the ``TPU`` namespace stays parseable so every YAML of the repo loads, and
  the port ignores it but for ``TPU.COMPUTE_DTYPE``, the model's compute
  dtype (``main.py``);
- ``yaml`` is imported only inside :meth:`Config.merge_from_file`, so the
  port runs where PyYAML is missing as long as no YAML file is read.
"""

from __future__ import annotations

import ast
import math
import os
from typing import Any, List, Optional, Sequence

import numpy as np

from .utils.collections import AttrDict


def _default_tree() -> AttrDict:
    """The default config tree (values equal the JAX package's defaults)."""
    cfg = AttrDict()

    cfg.MODEL = AttrDict(
        PRETRAIN_IMAGENET_MODEL=os.path.join("datasets/pretrain_model", "resnet50_imagenet.npz"),
        PRETRAIN_COCO_MODEL=os.path.join("datasets/pretrain_model", "mask_rcnn_coco.npz"),
        INIT_FILE_CHOICE="last",
        INIT_MODEL=None,
        BACKBONE="resnet101",
        BACKBONE_STRIDES=[],
        BACKBONE_SHAPES=[],
        STRICT_QUIRKS=True,
    )

    cfg.DATASET = AttrDict(
        NUM_CLASSES=81,
        YEAR="2014",
        PATH="datasets/coco",
    )

    cfg.RPN = AttrDict(
        ANCHOR_SCALES=(32, 64, 128, 256, 512),
        ANCHOR_RATIOS=[0.5, 1, 2],
        ANCHOR_STRIDE=1,
        NMS_THRESHOLD=0.7,
        TRAIN_ANCHORS_PER_IMAGE=256,
        PRE_NMS_LIMIT=6000,
        POST_NMS_ROIS_TRAINING=2000,
        POST_NMS_ROIS_INFERENCE=1000,
        TARGET_POS_THRES=0.7,
        TARGET_NEG_THRES=0.3,
    )

    cfg.MRCNN = AttrDict(
        USE_MINI_MASK=True,
        MINI_MASK_SHAPE=(56, 56),
        POOL_SIZE=7,
        MASK_POOL_SIZE=14,
        MASK_SHAPE=[28, 28],
    )

    cfg.DATA = AttrDict(
        IMAGE_MIN_DIM=800,
        IMAGE_MAX_DIM=1024,
        MULTISCALE_MIN_DIMS=[],
        IMAGE_PADDING=True,
        MEAN_PIXEL=np.array([123.7, 116.8, 103.9]),
        MAX_GT_INSTANCES=100,
        BBOX_STD_DEV=np.array([0.1, 0.1, 0.2, 0.2]),
        IMAGE_SHAPE=[],
        LOADER_WORKER_NUM=2,
        LOADER_WORKER_MODE="thread",
    )

    cfg.ROIS = AttrDict(
        TRAIN_ROIS_PER_IMAGE=200,
        ROI_POSITIVE_RATIO=0.33,
        ASSIGN_ANCHOR_BASE=224.0,
        METHOD="roi_align",        # or 'roi_pool'
        WINDOW_CAP=8,
    )

    cfg.TEST = AttrDict(
        BATCH_SIZE=0,              # derived: 2 * TRAIN.BATCH_SIZE
        DET_MAX_INSTANCES=100,
        DET_MIN_CONFIDENCE=0.0,
        DET_NMS_THRESHOLD=0.3,
        SAVE_IM=False,
        DTYPE="",
        MULTI_SCALE=[],
        MULTI_SCALE_NMS_THRESHOLD=0.5,
    )

    cfg.TRAIN = AttrDict(
        BATCH_SIZE=6,
        OPTIM_METHOD="sgd",
        INIT_LR=0.01,
        MOMENTUM=0.9,
        WEIGHT_DECAY=0.0001,
        GAMMA=0.1,
        LR_POLICY="steps_with_decay",
        END2END=False,
        SCHEDULE=[6, 4, 3],
        LR_WARM_UP=False,
        LR_WP_ITER=500,
        LR_WP_FACTOR=1.0 / 3.0,
        CLIP_GRAD=True,
        MAX_GRAD_NORM=5.0,
        BN_LEARN=False,
        DO_VALIDATION=True,
        SAVE_FREQ_WITHIN_EPOCH=10,
        KEEP_CHECKPOINTS=0,
        STRICT_RESUME=False,
        FORCE_START_EPOCH=0,
        FPN_OT_LOSS=False,
        FPN_OT_LOSS_FAC=1.0,
    )

    cfg.DEV = AttrDict(
        SWITCH=False,
        INIT_BUFFER_WEIGHT="scratch",
        BUFFER_SIZE=1000,
        EFFECT_AFER_EP_PERCENT=0.0,
        MULTI_UPSAMPLER=False,
        UPSAMPLE_FAC=2.0,
        UPSAMPLE_INIT="xavier",
        UPSAMPLE_RESIDUAL=False,
        LOSS_CHOICE="l1",          # 'l1' | 'l2' | 'kl' | 'ot'
        OT_ONE_DIM_FORM="conv",
        LOSS_FAC=0.5,
        INST_LOSS=False,
        FEAT_BRANCH_POOL_SIZE=14,
        DIS_REG_LOSS=False,
        ASSIGN_BOX_ON_ALL_SCALE=False,
        BASELINE=False,
        BIG_SUPERVISE=False,
        BIG_LOSS_CHOICE="ce",
        BIG_FC_INIT="scratch",
        BIG_LOSS_FAC=1.0,
        BIG_FC_INIT_LIST={},
        STRUCTURE="beta",
        DIS_UPSAMPLER=False,
        BIG_FEAT_DETACH=True,
        CLS_MERGE_FEAT=False,
        CLS_MERGE_MANNER="simple_add",
        CLS_MERGE_FAC=0.5,
    )

    cfg.CTRL = AttrDict(
        CONFIG_NAME="",
        PHASE="",
        DEBUG=None,
        QUICK_VERIFY=False,
        SHOW_INTERVAL=50,
        PROFILE_ANALYSIS=False,
    )

    cfg.TSNE = AttrDict(
        SKIP_INFERENCE=True,
        A_FEW=False,
        PERPLEXITY=30,
        METRIC="euclidean",
        N_TOPICS=2,
        BATCH_SZ=1024,
        TOTAL_EP=150,
        ELLIPSE=True,
        SAMPLE_CHOICE="set1",
        FIG_FOLDER_SUX="debug5",
    )

    cfg.MISC = AttrDict(
        SEED=2000,
        USE_VISDOM=False,
        VIS=AttrDict(PORT=-1),
        LOG_FILE=None,
        DET_RESULT_FILE=None,
        SAVE_IMAGE_DIR=None,
        RESULT_FOLDER=None,
        DEVICE_ID=[0],
        GPU_COUNT=1,
    )

    # The JAX package's TPU options: parsed so that every YAML loads, and
    # ignored by the port but for COMPUTE_DTYPE, the one TPU key it reads: the
    # command line builds the model in it (float32 parameters either way).
    cfg.TPU = AttrDict(
        MESH_DATA=-1,
        COMPUTE_DTYPE="bfloat16",
        PARAM_DTYPE="float32",
        USE_PALLAS=False,
        ROI_WINDOW_KERNEL=True,
        ROI_WINDOW_SIZE=32,
        MAX_PRE_NMS=6000,
        REMAT_BACKBONE=True,
        COMPILE_CACHE_DIR="",
    )

    # The port's own options, none yet. The namespace exists before any
    # merge so that a YAML file may hold a CUDA section, and a key the port
    # does not have is rejected there as anywhere else. The device is an
    # argument of the entry points, not an option.
    cfg.CUDA = AttrDict()

    return cfg


def _coerce(new: Any, old: Any, key: str) -> Any:
    """Coerce ``new`` to the type of ``old``: strings are literal-eval'd when
    possible; list/tuple and int/float mismatches are converted; numpy array
    targets accept lists."""
    if isinstance(new, str):
        try:
            new = ast.literal_eval(new)
        except (ValueError, SyntaxError):
            pass
    if old is None or isinstance(new, type(old)):
        return new
    if isinstance(old, np.ndarray):
        return np.array(new, dtype=old.dtype)
    if isinstance(old, tuple) and isinstance(new, list):
        return tuple(new)
    if isinstance(old, list) and isinstance(new, tuple):
        return list(new)
    if isinstance(old, bool) and isinstance(new, int):
        return bool(new)
    if isinstance(old, float) and isinstance(new, int):
        return float(new)
    if isinstance(old, int) and isinstance(new, float) and new == int(new):
        return int(new)
    if old is not None and new is None:
        return None
    raise TypeError(
        f"Type mismatch for config key {key!r}: cannot coerce "
        f"{type(new).__name__} -> {type(old).__name__}"
    )


class Config:
    """The full configuration object.

    Usage::

        cfg = Config()
        cfg.merge_from_file("configs/105/meta_105_quick_1.yaml")
        cfg.merge_from_list(["TRAIN.BATCH_SIZE", "2", "DEV.SWITCH", "True"])
        cfg.finalize()
    """

    def __init__(self) -> None:
        self._tree = _default_tree()
        self._finalized = False

    def __getattr__(self, name: str) -> Any:
        tree = object.__getattribute__(self, "_tree")
        if name in tree:
            return tree[name]
        raise AttributeError(name)

    def namespaces(self) -> List[str]:
        return list(self._tree.keys())

    def merge_from_file(self, path: str) -> None:
        import yaml  # only needed to read YAML; the port runs without it

        with open(path) as f:
            overlay = yaml.safe_load(f) or {}
        self._merge_dict(overlay, self._tree, prefix="")

    def merge_from_list(self, opts: Sequence[str]) -> None:
        if len(opts) % 2 != 0:
            raise ValueError(f"Override list must have even length, got {len(opts)}")
        for full_key, value in zip(opts[0::2], opts[1::2]):
            parts = full_key.split(".")
            node = self._tree
            for part in parts[:-1]:
                if part not in node:
                    raise KeyError(f"Unknown config namespace {part!r} in {full_key!r}")
                node = node[part]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Unknown config key {full_key!r}")
            node[leaf] = _coerce(value, node[leaf], full_key)

    def _merge_dict(self, overlay: dict, node: AttrDict, prefix: str) -> None:
        for key, value in overlay.items():
            full_key = f"{prefix}{key}"
            if key not in node:
                raise KeyError(f"Unknown config key {full_key!r} in YAML overlay")
            if isinstance(value, dict) and isinstance(node[key], AttrDict):
                self._merge_dict(value, node[key], prefix=f"{full_key}.")
            else:
                node[key] = _coerce(value, node[key], full_key)

    def finalize(self, make_dirs: bool = False) -> "Config":
        """Compute derived values, as the JAX package's finalize does."""
        c = self._tree

        if c.CTRL.QUICK_VERIFY:
            c.CTRL.SHOW_INTERVAL = 5
            c.TRAIN.SAVE_FREQ_WITHIN_EPOCH = 2
        if c.CTRL.DEBUG:
            c.CTRL.SHOW_INTERVAL = 1
            c.DATA.IMAGE_MIN_DIM = 320
            c.DATA.IMAGE_MAX_DIM = 512
            c.CTRL.PROFILE_ANALYSIS = False
            c.TSNE.A_FEW = True

        c.MISC.RESULT_FOLDER = os.path.join(
            "results", (c.CTRL.CONFIG_NAME or "default").lower(), c.CTRL.PHASE or "train"
        )
        if make_dirs:
            os.makedirs(c.MISC.RESULT_FOLDER, exist_ok=True)

        c.TEST.BATCH_SIZE = 2 * c.TRAIN.BATCH_SIZE

        if c.MODEL.BACKBONE in ("resnet50", "resnet101"):
            c.MODEL.BACKBONE_STRIDES = [4, 8, 16, 32, 64]
        else:
            raise ValueError(f"unknown backbone {c.MODEL.BACKBONE!r}")

        c.DATA.IMAGE_SHAPE = np.array([c.DATA.IMAGE_MAX_DIM, c.DATA.IMAGE_MAX_DIM, 3])
        c.MODEL.BACKBONE_SHAPES = np.array(
            [
                [int(math.ceil(c.DATA.IMAGE_SHAPE[0] / s)),
                 int(math.ceil(c.DATA.IMAGE_SHAPE[1] / s))]
                for s in c.MODEL.BACKBONE_STRIDES
            ]
        )

        n_dev = c.TPU.MESH_DATA if c.TPU.MESH_DATA > 0 else len(c.MISC.DEVICE_ID)
        if n_dev >= 8:
            c.DATA.LOADER_WORKER_NUM = max(c.DATA.LOADER_WORKER_NUM, 32)
        elif n_dev >= 4:
            c.DATA.LOADER_WORKER_NUM = max(c.DATA.LOADER_WORKER_NUM, 16)

        if c.DEV.BIG_FC_INIT == "coco_pretrain":
            c.DEV.BIG_FC_INIT_LIST = {
                "dev/big_fc/kernel": "classifier/linear_class/kernel",
                "dev/big_fc/bias": "classifier/linear_class/bias",
            }

        if c.TPU.COMPUTE_DTYPE not in ("bfloat16", "float32"):
            raise ValueError(
                "TPU.COMPUTE_DTYPE must be 'bfloat16' or 'float32', got "
                f"{c.TPU.COMPUTE_DTYPE!r}")
        if c.TEST.DTYPE not in ("", "bfloat16", "float32"):
            raise ValueError(
                "TEST.DTYPE must be '', 'bfloat16' or 'float32', got "
                f"{c.TEST.DTYPE!r}")

        c.TPU.MAX_PRE_NMS = int(c.RPN.PRE_NMS_LIMIT)
        self._finalized = True
        return self

    def display(self, log_fn=print) -> None:
        for ns in self.namespaces():
            log_fn(f"{ns}:")
            for key, value in self._tree[ns].items():
                log_fn(f"\t{key:30}\t\t{value}")

    def to_dict(self) -> dict:
        def conv(node):
            if isinstance(node, AttrDict):
                return {k: conv(v) for k, v in node.items()}
            if isinstance(node, np.ndarray):
                return node.tolist()
            return node
        return conv(self._tree)


# The flagship recipe (configs/105/meta_105_quick_1.yaml) as overrides, so a
# machine without PyYAML builds it; tests hold it equal to the YAML.
FLAGSHIP_OVERRIDES = (
    "TRAIN.LR_WARM_UP", "False",
    "TRAIN.CLIP_GRAD", "True",
    "TRAIN.END2END", "False",
    "TRAIN.BATCH_SIZE", "4",
    "TRAIN.DO_VALIDATION", "True",
    "DATA.IMAGE_MIN_DIM", "800",
    "DATA.IMAGE_MAX_DIM", "1024",
    "DEV.SWITCH", "True",
    "DEV.BUFFER_SIZE", "1",
    "DEV.LOSS_CHOICE", "l2",
    "DEV.LOSS_FAC", "10.0",
    "DEV.STRUCTURE", "beta",
    "DEV.ASSIGN_BOX_ON_ALL_SCALE", "False",
    "DEV.DIS_UPSAMPLER", "False",
    "DEV.UPSAMPLE_FAC", "1.0",
    "DEV.BIG_FEAT_DETACH", "True",
    "CTRL.QUICK_VERIFY", "False",
)


def build_config(
    config_name: str = "default",
    phase: str = "train",
    config_file: Optional[str] = None,
    opts: Optional[Sequence[str]] = None,
    debug: Optional[bool] = None,
    make_dirs: bool = False,
) -> Config:
    """Build and finalize a config the way main.py does."""
    cfg = Config()
    cfg.CTRL.CONFIG_NAME = config_name
    cfg.CTRL.PHASE = phase
    cfg.CTRL.DEBUG = debug
    if config_file is not None:
        cfg.CTRL.CONFIG_NAME = os.path.basename(config_file).replace(".yaml", "")
        cfg.merge_from_file(config_file)
    if opts:
        cfg.merge_from_list(list(opts))
    return cfg.finalize(make_dirs=make_dirs)
