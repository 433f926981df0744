"""ctypes bindings for the native C++ CIDEr scorer (``csrc/cider.cc``).

The port's copy of ``captionax/eval/cider_native.py``.  The source is
compiled from the repository, unedited, into ``captionax_torch/_build/`` at
first use (``core/native_build.py``); where it cannot be built,
:func:`cider_score_native` falls back to the Python
:func:`~captionax_torch.eval.cider.cider_score`.  The two agree within 1e-9
on text whose words are split by plain spaces.  They differ where other
whitespace separates words: the C++ splits on ``' '`` only, the Python
scorer on any whitespace (a no-break space joins two words for the first
and parts them for the second).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from captionax_torch.core import native_build

SOURCE = native_build.CSRC / "cider.cc"

_LIB: Optional[ctypes.CDLL] = None
_LOAD_FAILED = False
_LOAD_LOCK = threading.Lock()


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64p = np.ctypeslib.ndpointer(np.int64)
    lib.cider_score.restype = ctypes.c_int
    lib.cider_score.argtypes = [
        ctypes.c_char_p, i64p, ctypes.c_int64, ctypes.c_char_p, i64p, i64p,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
    ]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _LOAD_FAILED
    with _LOAD_LOCK:
        if _LIB is None and not _LOAD_FAILED:
            _LIB = native_build.load(SOURCE, _bind)
            _LOAD_FAILED = _LIB is None
        return _LIB


def native_available() -> bool:
    """Whether the native scorer is built and loaded (building it if needed)."""
    return _load() is not None


def cider_score_native(
    hypotheses: Sequence[str],
    references: Sequence[Sequence[str]],
) -> Tuple[float, np.ndarray]:
    """Drop-in for :func:`captionax_torch.eval.cider.cider_score` (n_max=4):
    -> (the corpus mean, the per-image scores)."""
    lib = _load()
    if lib is None:
        from captionax_torch.eval.cider import cider_score

        return cider_score(hypotheses, references)
    num = len(hypotheses)
    if num == 0:
        return 0.0, np.zeros((0,))
    if len(references) != num:
        raise ValueError(f"{num} hypotheses but {len(references)} reference sets")
    hyp_blob, hyp_offs = native_build.strings_blob(hypotheses)
    ref_blob, ref_offs = native_build.strings_blob([r for refs in references for r in refs])
    ref_index = np.zeros(num + 1, np.int64)
    ref_index[1:] = np.cumsum([len(refs) for refs in references])
    out = np.zeros(num, np.float64)
    rc = lib.cider_score(hyp_blob, hyp_offs, num, ref_blob, ref_offs, ref_index, out)
    if rc != 0:  # pragma: no cover
        raise RuntimeError(f"native cider failed with code {rc}")
    return float(out.mean()), out
