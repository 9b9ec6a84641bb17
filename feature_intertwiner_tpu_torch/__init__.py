"""PyTorch/CUDA port of internet-tpu (InterNet, the Feature Intertwiner
detector), for one NVIDIA H100.

The JAX package ``feature_intertwiner_tpu`` is the reference; this package
imports nothing of it, nor JAX. It mirrors its layout:

- ``ops``     box math, anchors, NMS, proposals, RoIAlign and its gradient,
              training targets, detection layer; three of the JAX
              package's TPU kernels as CUDA kernels
              (``csrc/roi_align_fwd.cu``, ``csrc/roi_align_bwd.cu``,
              ``csrc/nms.cu``), built with nvcc at first use;
- ``models``  ResNet-FPN, RPN, Dev (the intertwiner RoI stage), heads, and
              the InterNet detector at inference and in training;
- ``train``   losses, the intertwiner buffer and meta loss, the train step,
              SGD with stage freezing, checkpoints and the three-stage
              trainer;
- ``data``    the synthetic dataset, the training transforms and the loader;
- ``utils``   the config's AttrDict, logging, and the weight and trainer
              state maps from the JAX package's trees;
- ``inference``  the entry points ``build_model`` and ``detect``;
- ``main``    the command line (``--phase train``).
"""

__version__ = "0.1.0"

from .config import Config, build_config  # noqa: F401
from .inference import build_model, detect  # noqa: F401
