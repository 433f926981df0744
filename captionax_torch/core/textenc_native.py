"""ctypes bindings for the native caption encoder (``csrc/textenc.cc``).

The port's copy of ``captionax/core/textenc_native.py``: strip periods,
lowercase, Treebank tokenize, vocab lookup, ``<s>``/``</s>`` wrap, pad, for
a whole batch of captions in one call.  The source is compiled from the
repository, unedited, into ``captionax_torch/_build/`` at first use
(``core/native_build.py``).  Where it cannot be built (no compiler),
:func:`native_available` is False and the datasets encode through
``Vocab.encode``.  On ASCII captions the two give the same ids; on other
text they differ, as captionax's do: the C++ lowercases byte by byte and
splits on ASCII whitespace only (``csrc/textenc.cc``), where ``Vocab.encode``
takes ``str.lower()`` and Unicode whitespace.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence

import numpy as np

from captionax_torch.core import native_build

SOURCE = native_build.CSRC / "textenc.cc"

_LIB: Optional[ctypes.CDLL] = None
_LOAD_FAILED = False
_LOAD_LOCK = threading.Lock()


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.textenc_vocab_new.restype = ctypes.c_void_p
    lib.textenc_vocab_new.argtypes = [
        ctypes.c_char_p, np.ctypeslib.ndpointer(np.int64), ctypes.c_int64,
    ]
    lib.textenc_vocab_free.restype = None
    lib.textenc_vocab_free.argtypes = [ctypes.c_void_p]
    lib.textenc_encode_batch.restype = ctypes.c_int
    lib.textenc_encode_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.int64), ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
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
    """Whether the native encoder is built and loaded (building it if needed)."""
    return _load() is not None


class NativeCaptionEncoder:
    """Batch caption -> padded id-array encoder over a fixed vocab.

    The C++ vocab behind it lives as long as the encoder.  A pickled
    encoder (a dataset sent to another process) carries its vocab only and
    builds its own C++ vocab where it is unpickled."""

    def __init__(self, vocab):
        lib = _load()
        if lib is None:
            raise RuntimeError("native text encoder unavailable")
        self._lib = lib
        self.vocab = vocab
        blob, offs = native_build.strings_blob([vocab.i2w[i] for i in range(len(vocab))])
        self._handle = lib.textenc_vocab_new(blob, offs, len(offs) - 1)
        self.bos = vocab.w2i["<s>"]
        self.eos = vocab.w2i["</s>"]
        self.unk = vocab.w2i["<unk>"]

    def encode_batch(self, captions: Sequence[str], max_len: int) -> np.ndarray:
        """-> int32 [len(captions), max_len]: ``<s>``, the tokens' ids, ``</s>``,
        cut at ``max_len`` and padded with 0."""
        blob, offs = native_build.strings_blob(captions)
        out = np.zeros((len(captions), max_len), np.int32)
        rc = self._lib.textenc_encode_batch(
            self._handle, blob, offs, len(captions),
            max_len, self.bos, self.eos, self.unk, out,
        )
        if rc != 0:  # pragma: no cover
            raise RuntimeError(f"textenc failed: {rc}")
        return out

    def __reduce__(self):
        return NativeCaptionEncoder, (self.vocab,)

    def __del__(self):
        handle, self._handle = getattr(self, "_handle", None), None
        if handle:
            self._lib.textenc_vocab_free(handle)
