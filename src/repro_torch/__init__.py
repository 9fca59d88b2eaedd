"""PyTorch + CUDA port of the A2WS reproduction (``src/repro`` is the JAX reference).

Layout mirrors ``src/repro``: ``core`` (the A2WS scheduler, copied verbatim:
pure Python and numpy), ``kernels.fd3d`` (the FD3D step as a CUDA kernel for
sm_90a, with its plain PyTorch version) and ``seismic`` (shots, the tasks
A2WS schedules).  Imports ``torch`` and ``numpy``, never ``jax`` nor
anything under ``repro``.
"""
