"""PyTorch + CUDA port of the Seer reproduction (``repro``, JAX).

Same module layout as ``repro``: each counterpart sits under the same
path.  The package imports ``torch`` and never ``jax`` or ``repro``; its
entry points put tensors on ``cuda`` unless the caller passes
``device="cpu"``.  Each Pallas TPU kernel of ``repro`` on a ported path
becomes a CUDA kernel written by hand for Hopper (``kernels/``).
"""
