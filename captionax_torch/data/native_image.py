"""Image bytes -> resized uint8 RGB arrays on the host.

The port's copy of ``captionax/data/native_image.py`` with its ctypes
loader: the repository's native decoder ``csrc/imgdec.cc`` (libjpeg/libpng
decode, the grayscale->viridis quirk, then a resize bit-identical to
Pillow's bilinear, batched over a C++ thread pool) is compiled with ``g++``
into ``captionax_torch/_build/`` at first use (``core/native_build.py``).
An image the native path cannot decode (an exotic format, corrupt bytes)
goes through PIL, one image at a time; where the library cannot be built
(no compiler, no libjpeg/libpng), every image does.  Where neither is
installed, decoding raises.  Gray images are replicated to RGB (PIL's ``convert("RGB")``) or,
with ``GRAY_VIRIDIS``, mapped through the viridis colormap before the
resize; 16-bit ones are scaled by 255/65535.
"""

from __future__ import annotations

import ctypes
import io
import os
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from captionax_torch.core import native_build

SOURCE = native_build.CSRC / "imgdec.cc"
LIBS = ("-ljpeg", "-lpng", "-lpthread")
GRAY_REPLICATE = 0  # PIL convert("RGB") semantics
GRAY_VIRIDIS = 1    # the Conceptual Captions loader's quirk (LUT applied before resize)
MAX_THREADS = 16

_LIB: Optional[ctypes.CDLL] = None
_LOAD_FAILED = False
_LOAD_LOCK = threading.Lock()


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = np.ctypeslib.ndpointer(np.uint8)
    lib.cx_img_decode_resize.restype = ctypes.c_int
    lib.cx_img_decode_resize.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p,
    ]
    lib.cx_img_probe.restype = ctypes.c_int
    lib.cx_img_probe.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.cx_img_decode.restype = ctypes.c_int
    lib.cx_img_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, u8p]
    lib.cx_img_decode_resize_batch.restype = ctypes.c_int
    lib.cx_img_decode_resize_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), np.ctypeslib.ndpointer(np.int64), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p, np.ctypeslib.ndpointer(np.int32),
        ctypes.c_int,
    ]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _LOAD_FAILED
    with _LOAD_LOCK:
        if _LIB is None and not _LOAD_FAILED:
            _LIB = native_build.load(SOURCE, _bind, LIBS)
            _LOAD_FAILED = _LIB is None  # do not rebuild per image after a failed build
        return _LIB


def native_available() -> bool:
    """Whether the native decoder is built and loaded (building it if needed)."""
    return _load() is not None


def _pil_to_rgb(im, gray_mode: int) -> np.ndarray:
    """PIL image -> uint8 RGB with the native path's semantics (the viridis
    quirk on gray sources, 16-bit gray scaled, not clamped; alpha dropped)."""
    if im.mode in ("L", "I;16", "I", "I;16B", "I;16L"):
        g = np.asarray(im)
        if g.dtype != np.uint8:
            g = ((g.astype(np.uint32) * 255 + 32767) // 65535).astype(np.uint8)
        if gray_mode == GRAY_VIRIDIS:
            from captionax_torch.data.transforms import grayscale_to_viridis

            return grayscale_to_viridis(g)
        return np.stack([g] * 3, axis=-1)
    return np.asarray(im.convert("RGB"), dtype=np.uint8)


def _pil_decode_resize(data: bytes, hw: Tuple[int, int], gray_mode: int) -> np.ndarray:
    """The per-image route, with the native path's semantics."""
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        rgb = Image.fromarray(_pil_to_rgb(im, gray_mode))
        return np.asarray(rgb.resize((hw[1], hw[0]), Image.BILINEAR), dtype=np.uint8)


def decode_resize(data: bytes, hw: Tuple[int, int] = (224, 224),
                  gray_mode: int = GRAY_REPLICATE) -> np.ndarray:
    """bytes -> uint8 RGB [h, w, 3]: the native decoder, PIL where it fails."""
    lib = _load()
    if lib is not None:
        out = np.empty((hw[0], hw[1], 3), np.uint8)
        if lib.cx_img_decode_resize(data, len(data), hw[0], hw[1], gray_mode, out) == 0:
            return out
    return _pil_decode_resize(data, hw, gray_mode)


def decode(data: bytes, gray_mode: int = GRAY_REPLICATE) -> np.ndarray:
    """bytes -> uint8 RGB [H, W, 3] at the image's own size."""
    lib = _load()
    if lib is not None:
        h, w = ctypes.c_int(0), ctypes.c_int(0)
        if lib.cx_img_probe(data, len(data), ctypes.byref(h), ctypes.byref(w)) == 0:
            out = np.empty((h.value, w.value, 3), np.uint8)
            if lib.cx_img_decode(data, len(data), gray_mode, out) == 0:
                return out
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        return _pil_to_rgb(im, gray_mode)


def decode_resize_batch(blobs: Sequence[bytes], hw: Tuple[int, int] = (224, 224),
                        gray_mode: int = GRAY_REPLICATE, threads: int = 0) -> np.ndarray:
    """[bytes, ...] -> uint8 [B, h, w, 3] across the C++ thread pool; the rows
    the native path refuses (a negative status) are decoded again by PIL.

    ``threads=0`` takes one thread per CPU, at most ``MAX_THREADS``."""
    lib = _load()
    B = len(blobs)
    out = np.zeros((B, hw[0], hw[1], 3), np.uint8)
    if B == 0:
        return out
    if lib is None:
        for i, b in enumerate(blobs):
            out[i] = _pil_decode_resize(b, hw, gray_mode)
        return out
    if threads <= 0:
        threads = min(os.cpu_count() or 1, MAX_THREADS)
    ptrs = (ctypes.c_char_p * B)(*blobs)
    lens = np.asarray([len(b) for b in blobs], np.int64)
    statuses = np.zeros((B,), np.int32)
    lib.cx_img_decode_resize_batch(ptrs, lens, B, hw[0], hw[1], gray_mode, out, statuses,
                                   threads)
    for i in np.flatnonzero(statuses < 0):
        out[i] = _pil_decode_resize(blobs[i], hw, gray_mode)
    return out


def make_file_loader(img_dir: str, hw: Tuple[int, int] = (224, 224),
                     gray_mode: int = GRAY_REPLICATE):
    """``image_loader(name)`` for the dataset classes: reads img_dir/name and
    returns it decoded and resized to uint8 [h, w, 3], so every image of a
    batch has one shape."""

    def load(name: str) -> np.ndarray:
        with open(os.path.join(img_dir, name), "rb") as f:
            return decode_resize(f.read(), hw, gray_mode)

    return load


def load_paths_batch(paths: List[str], hw: Tuple[int, int] = (224, 224),
                     gray_mode: int = GRAY_REPLICATE, threads: int = 0) -> np.ndarray:
    """Read, decode and resize a list of files into one uint8 [B, h, w, 3]."""
    blobs = []
    for p in paths:
        with open(p, "rb") as f:
            blobs.append(f.read())
    return decode_resize_batch(blobs, hw, gray_mode, threads)
