"""PyTorch/CUDA port of ``repro``: the same OCR runtime, models and serve
engine, with the Pallas TPU kernels rewritten as CUDA kernels for Hopper
(``repro_torch.kernels``).

Module names follow ``repro`` one for one.  The package imports ``torch``
and ``numpy`` only — never ``jax`` and nothing of ``repro``; the
framework-free parts (``core``, ``analysis``, ``monitoring``,
``configs``) are copies kept here.
"""
