"""captionax_torch — the PyTorch / CUDA port of captionax for one NVIDIA H100.

A package of its own beside ``captionax/``: it imports ``torch`` and never
``jax`` or anything of ``captionax``.  Parameters keep the JAX package's
dict-of-arrays layout (as dicts of tensors), so the tests hold each port
function against its captionax counterpart on the same weights.

Entry points take ``device=None``, which means ``"cuda"``; they raise when
no card is present instead of carrying on on the CPU.  Pass
``device="cpu"`` to run the plain PyTorch versions (as the tests do).
"""

__all__ = ["core", "data", "decode", "interop", "models", "ops", "train"]
