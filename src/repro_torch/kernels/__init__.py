"""Hand-written Hopper kernels of the port, one package per TPU kernel
of the JAX package (``repro.kernels``).  Each holds the CUDA source under
``csrc/``, its plain PyTorch version (``ref.py``) and the wrapper that
checks and launches it (``ops.py``); ``build.py`` compiles the sources."""
