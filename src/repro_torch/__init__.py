"""Espresso's packed BMLP and BCNN forwards, the packed binary LM
(``models/transformer.py``) and the model zoo (the ten registry
architectures in ``configs/`` through ``models/model.py``), served by
``train/serve.py``'s ``BatchedServer`` and trained by
``train/trainer.py``, on PyTorch and hand-written CUDA kernels.

The port of ``src/repro`` (JAX + Pallas) to an NVIDIA Hopper card.  It
keeps the reference's word layout, so packed tensors compare word for
word: 32-bit words, LSB-first, packed along the last (channel) axis,
zero-bit tails.  Packed words live in ``torch.int32`` tensors with the
bit pattern of the reference's ``uint32`` arrays; the CUDA kernels read
them as ``uint32_t``.

Entry points run on the card unless the caller asks for the CPU
(``pack_bcnn(..., device="cpu")``, ``pack_bmlp(..., device="cpu")``,
``pack_transformer(..., device="cpu")``); on
the CPU the dispatchers of ``kernels/ops.py`` run each kernel's plain
PyTorch version, and the kernel wrappers themselves take CUDA tensors
only.  This package imports
``torch``, numpy and the standard library only.
"""
