"""Hand-written Hopper kernels of the port, one package per TPU kernel
of the JAX package (``repro.kernels``), and two the port adds for its
engine path's row invariance (``row_gemm``: the products; ``row_reduce``:
RMSNorm and the logits' log-sum-exp), where the reference leaves the
work to XLA.  Each holds the CUDA source under ``csrc/``, its plain
PyTorch version (``ref.py``) and the wrapper that checks and launches it
(``ops.py``); ``build.py`` compiles the sources."""
