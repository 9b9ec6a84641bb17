"""Shared building blocks: layers that compute in their input's dtype, BN
per site, TF-"SAME" padding, weight init.

The modules are NCHW; the model keeps its activations in
``torch.channels_last`` memory, so an NHWC view of a map is free.

Compute dtype, as flax's ``dtype``/``param_dtype``: parameters stay
float32, and :class:`Conv1d`, :class:`Conv2d`, :class:`ConvTranspose2d` and
:class:`Linear` (and their SAME-padded kinds) cast their weight and bias to
their input's dtype (bfloat16 in a bfloat16
model) and give a result in it. :class:`BatchNorm2d` takes a bfloat16 input
with its float32 affine parameters and running statistics, computes in
float32 and gives bfloat16, as flax's ``BatchNorm(dtype=bfloat16)`` does.
The model casts its images to its dtype before the backbone
(``models/detector.py``), so every layer after runs in it; the modules
cast back to float32 where the JAX package does.

BatchNorm epsilons per site, as in the JAX package (``models/common.py``):
1e-3 for the backbone, FPN, classifier and mask head, 1e-5 for the Dev
upsampler and critic. Momenta are torch's for the same sites (0.01 and 0.1;
flax's 0.99 and 0.9). In ``eval()`` BN reads its running statistics, at
inference and in training (the JAX package's default). In ``train()``
(:func:`bn_learning`, ``TRAIN.BN_LEARN``) it learns batch statistics as
flax's ``BatchNorm(use_running_average=False)`` does, not as
``nn.BatchNorm2d`` would (see :class:`BatchNorm2d`).

Padding: flax ``padding='SAME'`` is symmetric for odd kernels at stride 1
(plain ``padding=k // 2``), but for stride 2 on an even input it pads
(0, 1); :class:`SamePad2d` does that explicitly.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Tuple

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3        # backbone, FPN, classifier, mask head
DEV_BN_EPS = 1e-5    # Dev upsampler and critic


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` (no ``output_size``) computing in its input's
    dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                                  self.stride, self.padding, self.output_padding,
                                  self.groups, self.dilation)


class SameConvTranspose2d(ConvTranspose2d):
    """flax ``ConvTranspose(kernel, strides, padding='SAME')``. flax pads the
    stride-dilated input ``(a, b)`` = :func:`same_transpose_padding`, which
    for 3×3 at stride 2 is (2, 1); torch pads ``k - 1 - padding`` on both
    sides and ``output_padding`` more after. So ``padding = k - 1 - a``, and
    the output loses its last ``a - b`` rows and columns (or gains ``b - a``
    of output padding). The weight holds flax's kernel spatially flipped
    (``utils/convert_weights.py``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int):
        a, b = same_transpose_padding(kernel, stride)
        super().__init__(in_channels, out_channels, kernel, stride, padding=kernel - 1 - a,
                         output_padding=max(b - a, 0))
        self.crop = max(a - b, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x)
        if self.crop:
            y = y[..., :y.shape[-2] - self.crop, :y.shape[-1] - self.crop]
        return y


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` computing in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class Linear(nn.Linear):
    """``nn.Linear`` computing in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


def batch_moments(x32: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``E[x]`` and ``E[x²]`` per channel of an NCHW float32 batch, reduced
    in float32 over N, H and W."""
    return x32.mean((0, 2, 3)), (x32 * x32).mean((0, 2, 3))


def exact_batch_moments(x32: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`batch_moments` whose values are the float32 roundings of the
    float64 moments, with :func:`batch_moments`' own gradient."""
    mean, mean2 = batch_moments(x32)
    x64 = x32.detach().double()
    return (mean + (x64.mean((0, 2, 3)).float() - mean).detach(),
            mean2 + ((x64 * x64).mean((0, 2, 3)).float() - mean2).detach())


@contextlib.contextmanager
def float64_moments() -> Iterator[None]:
    """Inside the block every learning :class:`BatchNorm2d` takes its batch
    moments from float64 (:func:`exact_batch_moments`): a step run so,
    against the same step run as it is, measures what the float32 rounding
    of the batch moments alone moves."""
    BatchNorm2d.moments = staticmethod(exact_batch_moments)
    try:
        yield
    finally:
        BatchNorm2d.moments = staticmethod(batch_moments)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training mode is flax's ``BatchNorm`` with
    ``use_running_average=False`` (flax 0.12 ``_compute_stats`` and
    ``_normalize``): the batch statistics reduced in float32 over N, H and
    W, the variance ``E[x²] - E[x]²`` clipped at 0 (``use_fast_variance``);
    the output ``(x - mean) · (rsqrt(var + eps) · weight) + bias`` in
    float32, cast to the input's dtype; the running statistics moved by
    ``m · ra + (1 - m) · stat`` with flax's momentum ``m = 1 - momentum``
    and the *biased* variance (torch's own training mode takes the unbiased
    one, n/(n-1) larger), and ``num_batches_tracked`` left alone. The
    gradient flows through the batch statistics. In ``eval()`` it is
    ``nn.BatchNorm2d``. ``moments`` takes the batch's ``E[x]`` and
    ``E[x²]`` (:func:`batch_moments`; :func:`float64_moments` swaps it)."""

    moments = staticmethod(batch_moments)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        x32 = x.float()
        mean, mean2 = self.moments(x32)
        var = (mean2 - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            m = 1.0 - self.momentum
            self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x32 - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


def batch_norm(channels: int, eps: float = BN_EPS, momentum: float = 0.01) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=eps, momentum=momentum)


@contextlib.contextmanager
def bn_learning(model: nn.Module, on: bool = True) -> Iterator[None]:
    """Inside the block every :class:`BatchNorm2d` of ``model`` learns batch
    statistics (``on``); each gets its own mode back after it. The rest of
    the model keeps its mode."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)] if on else []
    modes = [m.training for m in bns]
    for m in bns:
        m.train(True)
    try:
        yield
    finally:
        for m, mode in zip(bns, modes):
            m.train(mode)


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF/flax SAME padding (before, after) along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SameConv2d(Conv2d):
    """A square-kernel :class:`Conv2d` with flax's ``padding='SAME'`` at any
    stride: the input is padded as :func:`same_padding` says, then
    convolved unpadded."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        top, bottom = same_padding(x.shape[-2], k, s)
        left, right = same_padding(x.shape[-1], k, s)
        return super().forward(F.pad(x, (left, right, top, bottom)))


def same_transpose_padding(kernel: int, stride: int) -> Tuple[int, int]:
    """(before, after) padding of the stride-dilated input of a flax/lax
    ``ConvTranspose`` with ``padding='SAME'`` along one axis."""
    total = kernel + stride - 2
    before = kernel - 1 if stride > kernel - 1 else -(-total // 2)
    return before, total - before


class SamePad2d(nn.Module):
    """Pad an NCHW map so that a ``kernel``/``stride`` window gives the TF
    "SAME" output; ``value`` fills the border (``-inf`` before a max-pool)."""

    def __init__(self, kernel: int, stride: int, value: float = 0.0):
        super().__init__()
        self.kernel, self.stride, self.value = kernel, stride, value

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        top, bottom = same_padding(x.shape[-2], self.kernel, self.stride)
        left, right = same_padding(x.shape[-1], self.kernel, self.stride)
        if top == bottom == left == right == 0:
            return x
        return F.pad(x, (left, right, top, bottom), value=self.value)


# flax's truncated_normal variance scaling draws N(0, 1) cut at +-2 and
# scales it by sqrt(variance) / TRUNC_STD, the standard deviation of that cut
# normal, so that the draw keeps the variance
TRUNC_STD = 0.87962566103423978


def bilinear_taps(kernel: int) -> torch.Tensor:
    """The per-axis taps of a stride-2 bilinear-upsampling transposed conv
    (JAX ``_bilinear_deconv_init``): [0.5, 1, 0.5] for 3."""
    c = (kernel - 1) / 2.0
    return 1.0 - (torch.arange(kernel, dtype=torch.float32) - c).abs() / 2


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights as the JAX package initialises them:
    Xavier-uniform convolutions (1-D and 2-D), Xavier-normal transposed
    convolutions
    (flax ``xavier_normal``: a normal truncated at two of its standard
    deviations, of variance 2 / (fan_in + fan_out)), N(0, 0.01) dense
    layers, zero biases, BN at identity (scale 1, bias 0, running
    statistics (0, 1)), a zero ``gate`` (the make-up layer's residual). A
    conv marked ``identity_init`` (``DEV.UPSAMPLE_INIT identity``) gets the
    delta kernel of the JAX ``_identity_conv_init`` (zero but the centre
    tap's [out, in] identity), a transposed conv so marked the bilinear
    kernel of ``_bilinear_deconv_init`` (:func:`bilinear_taps` per axis
    times the [in, out] identity; the kernel is symmetric, so the flip the
    port's transposed convs hold leaves it as it is). The generator is a
    CPU generator; initialise before moving the model."""
    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            # fan_in + fan_out, the same for a conv and its transpose
            fans = (w.shape[0] + w.shape[1]) * w[0, 0].numel()
            if getattr(m, "identity_init", False):
                eye = torch.eye(w.shape[0], w.shape[1])
                if isinstance(m, nn.ConvTranspose2d):
                    taps = bilinear_taps(w.shape[2])[:, None] * bilinear_taps(w.shape[3])[None]
                    w.copy_(eye[:, :, None, None] * taps)
                else:
                    w.zero_()
                    w[:, :, w.shape[2] // 2, w.shape[3] // 2] = eye
            elif isinstance(m, nn.ConvTranspose2d):
                std = math.sqrt(2.0 / fans) / TRUNC_STD
                nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator).mul_(std)
            else:
                bound = math.sqrt(6.0 / fans)
                w.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Linear):
            m.weight.normal_(0.0, 0.01, generator=generator)
            m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        if isinstance(getattr(m, "gate", None), nn.Parameter):
            m.gate.zero_()
    return model
