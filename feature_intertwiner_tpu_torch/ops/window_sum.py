"""Per-box window sums of an NHWC map, the port of the JAX package's window
probe ``scripts/profile_window_dma.py::window_dma_checksum``.

``window_sum(img, origins, sy, sx)``: img [B, H, W, C] float32 or bfloat16,
origins [N, 3] int32 ``(b, y0, x0 // 8)`` (the JAX contract: x is stored
divided by 8 and multiplied back) -> [N, C] float32, the sum of each
``img[b, y0:y0+sy, 8 x0:8 x0+sx, :]`` window. A window that leaves the map
gives NaN.

On CUDA tensors :func:`window_sum` launches ``csrc/window_sum.cu`` (which
replaces the Pallas kernel ``scripts/profile_window_dma.py::_probe_kernel``)
and raises if it cannot; on CPU tensors it runs :func:`window_sum_plain`,
which adds each window's pixels in the kernel's order and so matches it bit
for bit. The kernel lets overlapping windows share their map rows: sorted
by ``b * H + y0``, the windows go in groups of :func:`window_plan`'s
``group`` to a block, which stages the rows they cover once in shared
memory, piece by piece, and adds each window's pixels from there; small
windows, which barely overlap, are read directly, and so is every window of
a map with an odd channel count or one that does not start on a channel
pair (one channel a lane). The sort (a key kernel
and ``torch.argsort``) runs on the card; nothing is read back to the host.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

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


# The constants of csrc/window_sum.cu: threads per block (kThreads), items
# per window in a chunk (kLanes), the most windows a staging block takes
# (kGroup), shared memory a block can use (kSharedLimit) and the ints of a
# block's scalars (kMetaInts).
WINDOW_THREADS = 512
WINDOW_LANES = 32
WINDOW_GROUP = 64
WINDOW_SHARED_BYTES = 232448
WINDOW_META_INTS = 8
# The plan: windows of at least WINDOW_GROUP_AREA pixels go WINDOW_GROUP to a
# block, which stages their rows in pieces of up to WINDOW_GROUP_PIECE
# pixels, two buffers of at most WINDOW_GROUP_BYTES in all; smaller ones are
# read directly, two channels a thread.
WINDOW_GROUP_AREA = 512
WINDOW_GROUP_PIECE = 256
WINDOW_GROUP_BYTES = 128 * 1024

_ITEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}


class WindowPlan(NamedTuple):
    group: int      # windows that share staged rows in a block; 1: read directly
    piece: int      # most pixels of a row a block stages at a time (0 when direct)
    vec: int        # channels per item: 4 where C and the map's start allow, 2, or 1
    chunk: int      # channels per block: WINDOW_LANES * vec
    blocks: int     # window blocks x channel chunks
    shared: int     # shared bytes per block


def window_shared_bytes(group: int, chunk: int, piece: int, item: int) -> int:
    """Shared memory of a staging block: its scalars and five ints per
    window, rounded up to 128 bytes, then two pieces of ``piece`` pixels x
    ``chunk`` channels of ``item`` bytes."""
    meta = -(-(WINDOW_META_INTS * 4 + group * 5 * 4) // 128) * 128
    return meta + 2 * piece * chunk * item


def window_vec(img: torch.Tensor) -> int:
    """Channels one thread reads at a time: 4 where C is a multiple of 4 and
    the map starts on a 4-channel boundary, 2 where C is even and the map
    starts on a channel pair, else 1."""
    c, ptr, item = img.shape[-1], img.data_ptr(), img.element_size()
    if c % 4 == 0 and ptr % (4 * item) == 0:
        return 4
    return 2 if c % 2 == 0 and ptr % (2 * item) == 0 else 1


@functools.lru_cache(maxsize=256)
def window_plan(n: int, sy: int, sx: int, c: int, dtype: torch.dtype, w: int,
                vec: int = 4) -> WindowPlan:
    """How the kernel splits ``n`` windows of ``sy x sx`` pixels over a map
    ``w`` pixels wide with ``c`` channels of ``dtype``, ``vec`` the map's
    :func:`window_vec`: read directly, one channel to an item, where ``vec``
    is 1; read directly, two channels to an item, below
    ``WINDOW_GROUP_AREA`` pixels; else staged in groups, ``vec`` channels to
    an item (2 where C is not a multiple of 4). Depends on the shapes alone,
    so the launch needs nothing from the card."""
    if vec == 1 or sy * sx < WINDOW_GROUP_AREA:
        lanes = 1 if vec == 1 else 2
        chunk = WINDOW_LANES * lanes
        blocks = -(-n // (WINDOW_THREADS // WINDOW_LANES)) * -(-c // chunk)
        return WindowPlan(1, 0, lanes, chunk, blocks, 0)
    vec = vec if c % 4 == 0 else 2
    item = _ITEM_BYTES[dtype]
    chunk = WINDOW_LANES * vec
    piece = min(w, WINDOW_GROUP_PIECE, WINDOW_GROUP_BYTES // (2 * chunk * item))
    blocks = -(-n // WINDOW_GROUP) * -(-c // chunk)
    return WindowPlan(WINDOW_GROUP, piece, vec, chunk, blocks,
                      window_shared_bytes(WINDOW_GROUP, chunk, piece, item))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """``csrc/window_sum.cu``'s library with its entry points typed."""
    lib = cuda_build.load("window_sum")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.window_sum_keys.restype = i32
    lib.window_sum_keys.argtypes = [ptr] + [i32] * 6 + [ptr] * 2
    lib.window_sum.restype = i32
    lib.window_sum.argtypes = [ptr, i32, ptr, ptr] + [i32] * 10 + [ptr] * 2
    return lib


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
    n = origins.shape[0]
    plan = window_plan(n, sy, sx, c, img.dtype, w, window_vec(img))
    out = torch.empty((n, c), dtype=torch.float32, device=img.device)
    lib = _library()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        order = None
        if plan.group > 1 and n > 0:
            keys = torch.empty(n, dtype=torch.int32, device=img.device)
            cuda_build.check(lib.window_sum_keys(origins.data_ptr(), n, b, h, w, sy, sx,
                                                 keys.data_ptr(), stream), "window_sum_keys")
            order = torch.argsort(keys, stable=True)
        err = lib.window_sum(img.data_ptr(), int(img.dtype == torch.bfloat16), origins.data_ptr(),
                             None if order is None else order.data_ptr(), n, b, h, w, c, sy, sx,
                             plan.group, plan.piece, plan.vec, out.data_ptr(), stream)
    cuda_build.check(err, "window_sum")
    if n > 0:  # the C entry launches nothing for no windows
        cuda_build.launches["window_sum"] += 1
    return out
