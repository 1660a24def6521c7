"""PyTorch/CUDA port of the device paths of ``eth_consensus_specs_tpu``.

The JAX package beside this one is the reference; every module here mirrors
the name of its counterpart there so a reader finds the pair. This package
imports ``torch`` and ``numpy`` only: never ``jax`` and nothing of the JAX
package (what it needs from it, such as preset constants and field lists,
it keeps as its own copy in ``config.py``).

Dtype convention. The torch builds this package targets do not implement
``+``, ``>>``, ``<`` or ``//`` on ``torch.uint64``/``torch.uint32``, so:

* u64 columns (balances, epochs, scores) are carried as ``torch.int64``
  tensors holding the same 64 bits. ``FAR_FUTURE_EPOCH = 2**64 - 1`` is
  carried as ``-1``; every compare and division of such a column goes
  through ``lanes.ult64``/``ule64``/``udiv64``, never a signed operator.
* u32 SHA-256 words are carried as ``torch.int32`` tensors holding the
  same 32 bits (big-endian words, as the JAX package lays them out).

The CUDA kernels under ``csrc/`` reinterpret these as ``uint64_t`` and
``uint32_t``. The plain torch versions (``*_ref``) work in int64 lanes,
masking SHA words to 32 bits after every add and shift.

Dispatch is by the tensors' device: a wrapper given CUDA tensors launches
its hand-written kernel (built on first use by ``_ext``) or raises; given
CPU tensors it runs its plain version.
"""
