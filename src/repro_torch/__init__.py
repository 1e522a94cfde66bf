"""PyTorch + CUDA port of the compressed-column SQL engine (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its
layout (``core/``, ``kernels/``) and holds each ported part to it. It
imports ``torch`` and numpy, never ``jax`` and nothing of ``repro``.
Entry points run on the CUDA device unless the caller passes
``device="cpu"``.
"""
