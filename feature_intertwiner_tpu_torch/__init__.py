"""PyTorch/CUDA port of internet-tpu (InterNet, the Feature Intertwiner
detector), for one NVIDIA H100.

The JAX package ``feature_intertwiner_tpu`` is the reference; this package
imports nothing of it, nor JAX. It mirrors its layout:

- ``ops``     box math, anchors, NMS, proposals, RoIAlign and its gradient,
              single-level grouped crops, the window sum, training targets,
              detection layer; all six of the JAX package's TPU kernels as
              CUDA kernels (``csrc/roi_align_fwd.cu``,
              ``csrc/roi_align_bwd.cu``, ``csrc/nms.cu``,
              ``csrc/crop_and_resize.cu``, ``csrc/window_sum.cu``), built
              with nvcc at first use;
- ``models``  ResNet-FPN, RPN, Dev (the intertwiner RoI stage), heads, and
              the InterNet detector at inference and in training;
- ``train``   losses, the intertwiner buffer and meta loss, the train step,
              SGD with stage freezing, checkpoints, the three-stage trainer
              and the COCO evaluation loop (``test_model``);
- ``data``    the synthetic dataset (with its COCO ground truth), the
              training transforms and the loader;
- ``evaluation``  COCO RLE masks (``native/maskrle.cpp``, built with g++ at
              first use), the COCO index and COCOeval;
- ``utils``   the config's AttrDict, logging, and the weight and trainer
              state maps from the JAX package's trees;
- ``tools``   ``profile_roi``, the timing tool of the RoI pooling kernels
              and the window probe;
- ``inference``  the entry points ``build_model`` and ``detect``;
- ``main``    the command line (``--phase train`` and ``inference``).
"""

__version__ = "0.1.0"

from .config import Config, build_config  # noqa: F401
from .inference import build_model, detect  # noqa: F401
