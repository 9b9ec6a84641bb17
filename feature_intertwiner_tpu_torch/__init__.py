"""PyTorch/CUDA port of internet-tpu (InterNet, the Feature Intertwiner
detector), for one NVIDIA H100.

The JAX package ``feature_intertwiner_tpu`` is the reference; this package
imports nothing of it, nor JAX. It mirrors its layout:

- ``ops``     box math, anchors, NMS, proposals, RoIAlign, detection layer;
              the two TPU kernels of the inference path as CUDA kernels
              (``csrc/roi_align_fwd.cu``, ``csrc/nms.cu``), built with nvcc
              at first use;
- ``models``  ResNet-FPN, RPN, Dev (the intertwiner RoI stage), heads, and
              the InterNet detector at inference;
- ``utils``   the config's AttrDict and the weight map from the JAX
              package's parameter trees;
- ``inference``  the entry points ``build_model`` and ``detect``.
"""

__version__ = "0.1.0"

from .config import Config, build_config  # noqa: F401
from .inference import build_model, detect  # noqa: F401
