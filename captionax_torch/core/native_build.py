"""Builds the repository's host libraries (``csrc/*.cc``) for the port.

The port's ctypes loaders (``data/native_image.py``, ``core/textenc_native.py``,
``eval/cider_native.py``) compile their source from ``csrc/``, unedited,
with ``g++`` (``$CXX``) and the flags of ``csrc/Makefile``, into
``captionax_torch/_build/`` at first use.  Nothing is written into
``csrc/``, where captionax's own ``make -C csrc`` puts its libraries.  The
library's name hashes its flags and its source, so an edited source builds
anew; concurrent builds (test workers) each compile to a temporary file
and ``os.replace`` it into place, so a reader never sees half a library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")


def build(source: Path, libs: Sequence[str] = ()) -> Path:
    """Compile ``source`` (with ``libs`` linked) unless it is built already.
    -> the shared library's path.  Raises ``OSError`` (no compiler) or
    ``subprocess.SubprocessError`` (the compile failed or timed out)."""
    libs = tuple(libs)
    digest = hashlib.sha256(" ".join(CXX_FLAGS + libs).encode() + source.read_bytes())
    out = BUILD_DIR / f"lib{source.stem}_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp, str(source), *libs],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(source: Path, bind: Callable[[ctypes.CDLL], ctypes.CDLL],
         libs: Sequence[str] = ()) -> Optional[ctypes.CDLL]:
    """:func:`build` then load and ``bind`` (declare the argument and result
    types); None where the library cannot be built or loaded."""
    try:
        return bind(ctypes.CDLL(str(build(source, libs))))
    except (OSError, subprocess.SubprocessError):
        return None


def strings_blob(strings: Sequence[str]) -> Tuple[bytes, np.ndarray]:
    """UTF-8 strings -> (one buffer, int64 [n + 1] byte offsets), the form
    the libraries take a list of strings in."""
    encoded = [x.encode("utf-8") for x in strings]
    offs = np.zeros(len(encoded) + 1, np.int64)
    offs[1:] = np.cumsum([len(e) for e in encoded])
    return b"".join(encoded), offs
