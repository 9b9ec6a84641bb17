"""COCO RLE masks: a ctypes binding over ``native/maskrle.cpp``.

Port of ``feature_intertwiner_tpu/evaluation/rle.py``: encode, decode,
merge, area, IoU, tight box and polygon rasterisation of COCO run-length
masks, and the compressed-counts string codec. The library is compiled
with ``g++`` into ``build/torch_kernels/`` at first use (never at import);
where the JAX copy falls back to numpy when the build fails, the port
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Sequence, Union

import numpy as np

from ..ops.cuda_build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent.parent / "native" / "maskrle.cpp"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_MAX_COUNTS = 4_000_000
_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    """The compiled library; its name carries a digest of the source and
    the flags, so an edited source is rebuilt."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libmaskrle-{digest}.so"


def lib() -> ctypes.CDLL:
    """The loaded library, compiled first if needed. Raises
    ``RuntimeError`` when ``g++`` fails or is missing."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            try:
                proc = subprocess.run(["g++", *_FLAGS, str(SOURCE), "-o", str(tmp)],
                                      capture_output=True, text=True)
            except OSError as exc:
                raise RuntimeError(f"cannot build {SOURCE.name}: {exc}") from exc
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        handle = ctypes.CDLL(str(out))
        u32p = ctypes.POINTER(ctypes.c_uint32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f64p = ctypes.POINTER(ctypes.c_double)
        i = ctypes.c_int
        sigs = {
            "rle_encode": (i, [u8p, i, i, u32p, i]),
            "rle_decode": (None, [u32p, i, i, i, u8p]),
            "rle_area": (ctypes.c_double, [u32p, i]),
            "rle_iou": (ctypes.c_double, [u32p, i, u32p, i, i]),
            "rle_merge_union": (i, [u32p, i, u32p, i, u32p, i]),
            "rle_to_bbox": (None, [u32p, i, i, f64p]),
            "bbox_iou": (None, [f64p, i, f64p, i, u8p, f64p]),
            "rle_from_poly": (i, [f64p, i, i, i, u32p, i]),
        }
        for name, (restype, argtypes) in sigs.items():
            fn = getattr(handle, name)
            fn.restype, fn.argtypes = restype, argtypes
        _lib = handle
        return handle


def _u32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _f64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _counts(written: int) -> int:
    if written <= 0:
        raise ValueError(f"an RLE of more than {_MAX_COUNTS} runs")
    return written


class RLE:
    """One RLE mask: canvas (h, w) and uint32 run lengths (starting with
    zeros), column-major."""

    __slots__ = ("h", "w", "counts")

    def __init__(self, h: int, w: int, counts: np.ndarray):
        self.h = int(h)
        self.w = int(w)
        self.counts = np.ascontiguousarray(counts, dtype=np.uint32)

    @staticmethod
    def encode(mask: np.ndarray) -> "RLE":
        """Binary mask [h, w]."""
        h, w = mask.shape
        col = np.ascontiguousarray(mask.astype(np.uint8).reshape(-1, order="F"))
        out = np.empty(_MAX_COUNTS, np.uint32)
        m = _counts(lib().rle_encode(col.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                     h, w, _u32(out), _MAX_COUNTS))
        return RLE(h, w, out[:m].copy())

    @staticmethod
    def from_poly(poly: Sequence[float], h: int, w: int) -> "RLE":
        xy = np.ascontiguousarray(poly, dtype=np.float64)
        out = np.empty(_MAX_COUNTS, np.uint32)
        m = _counts(lib().rle_from_poly(_f64(xy), xy.size // 2, h, w, _u32(out), _MAX_COUNTS))
        return RLE(h, w, out[:m].copy())

    @staticmethod
    def from_coco(obj, h: int, w: int) -> "RLE":
        """From a COCO segmentation: a polygon list, an uncompressed dict or
        a compressed string."""
        if isinstance(obj, list):
            return RLE.merge([RLE.from_poly(p, h, w) for p in obj])
        counts = obj["counts"] if isinstance(obj, dict) else obj
        hh, ww = obj.get("size", [h, w]) if isinstance(obj, dict) else [h, w]
        if isinstance(counts, (bytes, str)):
            return RLE(hh, ww, _string_to_counts(counts))
        return RLE(hh, ww, np.asarray(counts, np.uint32))

    @staticmethod
    def merge(rles: List["RLE"]) -> "RLE":
        """Union of masks (multi-polygon instances)."""
        if not rles:
            raise ValueError("RLE.merge needs at least one mask")
        acc = rles[0]
        for r in rles[1:]:
            out = np.empty(_MAX_COUNTS, np.uint32)
            m = _counts(lib().rle_merge_union(_u32(acc.counts), len(acc.counts), _u32(r.counts),
                                              len(r.counts), _u32(out), _MAX_COUNTS))
            acc = RLE(acc.h, acc.w, out[:m].copy())
        return acc

    def decode(self) -> np.ndarray:
        out = np.zeros(self.h * self.w, np.uint8)
        lib().rle_decode(_u32(self.counts), len(self.counts), self.h, self.w,
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return out.reshape((self.h, self.w), order="F")

    def area(self) -> float:
        return lib().rle_area(_u32(self.counts), len(self.counts))

    def iou(self, other: "RLE", iscrowd: bool = False) -> float:
        return lib().rle_iou(_u32(self.counts), len(self.counts), _u32(other.counts),
                             len(other.counts), int(iscrowd))

    def bbox(self) -> np.ndarray:
        """(x, y, w, h)."""
        out = np.zeros(4, np.float64)
        lib().rle_to_bbox(_u32(self.counts), len(self.counts), self.h, _f64(out))
        return out

    def to_coco(self) -> dict:
        return {"size": [self.h, self.w], "counts": _counts_to_string(self.counts)}


# --- COCO compressed-counts strings (LEB128-like, delta coded) -----------------------
def _counts_to_string(counts: np.ndarray) -> str:
    out = []
    for i, c in enumerate(counts.tolist()):
        x = int(c)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            cc = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not (cc & 0x10)) or (x == -1 and (cc & 0x10)))
            if more:
                cc |= 0x20
            out.append(chr(cc + 48))
    return "".join(out)


def _string_to_counts(s: Union[str, bytes]) -> np.ndarray:
    if isinstance(s, bytes):
        s = s.decode("ascii")
    counts = []
    i = 0
    while i < len(s):
        x, k, more = 0, 0, True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * (k + 1))
            k += 1
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return np.asarray(counts, np.uint32)


def bbox_iou_matrix(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """xywh box IoU matrix [m, n] with the COCO crowd convention."""
    dt = np.ascontiguousarray(dt, np.float64).reshape(-1, 4)
    gt = np.ascontiguousarray(gt, np.float64).reshape(-1, 4)
    iscrowd = np.ascontiguousarray(iscrowd, np.uint8)
    m, n = len(dt), len(gt)
    if m == 0 or n == 0:
        return np.zeros((m, n))
    out = np.zeros(m * n, np.float64)
    lib().bbox_iou(_f64(dt), m, _f64(gt), n,
                   iscrowd.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), _f64(out))
    return out.reshape(m, n)
