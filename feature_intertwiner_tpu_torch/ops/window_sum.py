"""Per-box window sums of an NHWC map, the port of the JAX package's window
probe ``scripts/profile_window_dma.py::window_dma_checksum``.

``window_sum(img, origins, sy, sx)``: img [B, H, W, C] float32 or bfloat16,
origins [N, 3] int32 ``(b, y0, x0 // 8)`` (the JAX contract: x is stored
divided by 8 and multiplied back) -> [N, C] float32, the sum of each
``img[b, y0:y0+sy, 8 x0:8 x0+sx, :]`` window. A window that leaves the map
gives NaN.

On CUDA tensors :func:`window_sum` launches ``csrc/window_sum.cu`` (which
replaces the Pallas kernel ``scripts/profile_window_dma.py::_probe_kernel``);
on CPU tensors it runs :func:`window_sum_plain`, which adds the window's
pixels in the kernel's order and so matches it bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build


def window_sum_plain(img: torch.Tensor, origins: torch.Tensor, sy: int, sx: int) -> torch.Tensor:
    """Plain version of the window-sum kernel: each window's pixels added in
    row-major order into a float32 sum, one pixel of every window at a
    time."""
    b, h, w, c = img.shape
    o = origins.to(torch.int64)
    bi, y0, x0 = o[:, 0], o[:, 1], 8 * o[:, 2]
    inside = (bi >= 0) & (bi < b) & (y0 >= 0) & (y0 + sy <= h) & (x0 >= 0) & (x0 + sx <= w)
    # rows of the flattened map; windows that leave it read row 0, then NaN
    base = torch.where(inside, (bi * h + y0) * w + x0, torch.zeros_like(bi))
    flat = img.reshape(-1, c)
    acc = torch.zeros((o.shape[0], c), dtype=torch.float32, device=img.device)
    for y in range(sy):
        for x in range(sx):
            acc = acc + flat[base + (y * w + x)].float()
    return torch.where(inside[:, None], acc, acc.new_tensor(float("nan")))


def window_sum(img: torch.Tensor, origins: torch.Tensor, sy: int, sx: int) -> torch.Tensor:
    """Window sums [N, C] float32 (see the module docstring).

    Kernel wrapper: each launch adds one to
    ``cuda_build.launches["window_sum"]``."""
    if img.dim() != 4 or img.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("window_sum: img must be a [B, H, W, C] float32 or bfloat16 map")
    if origins.dim() != 2 or origins.shape[1] != 3 or origins.dtype != torch.int32:
        raise ValueError("window_sum: origins must be [N, 3] int32 (b, y0, x0 // 8)")
    if origins.device != img.device:
        raise ValueError("window_sum: img and origins must be on one device")
    sy, sx = int(sy), int(sx)
    if sy < 1 or sx < 1:
        raise ValueError(f"window_sum: window ({sy}, {sx}) must be at least 1 x 1")
    if img.device.type == "cpu":
        return window_sum_plain(img, origins, sy, sx)
    if img.device.type != "cuda":
        raise ValueError(f"window_sum runs on cuda or cpu, not {img.device}")
    if not (img.is_contiguous() and origins.is_contiguous()):
        raise ValueError("window_sum needs a contiguous map and origins")
    b, h, w, c = img.shape
    if c % 2:
        raise ValueError(f"window_sum: the kernel reads channel pairs, C = {c} is odd")
    n = origins.shape[0]
    out = torch.empty((n, c), dtype=torch.float32, device=img.device)
    fn = cuda_build.load("window_sum").window_sum
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 7 + [
        ctypes.c_void_p, ctypes.c_void_p]
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = fn(img.data_ptr(), int(img.dtype == torch.bfloat16), origins.data_ptr(), n, b,
                 h, w, c, sy, sx, out.data_ptr(), stream)
    cuda_build.check(err, "window_sum")
    if n > 0:  # the C entry launches nothing for no windows
        cuda_build.launches["window_sum"] += 1
    return out
