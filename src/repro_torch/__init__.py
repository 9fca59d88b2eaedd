"""PyTorch + CUDA port of the A2WS reproduction (``src/repro`` is the JAX reference).

Layout mirrors ``src/repro``: ``core`` (the A2WS scheduler, copied verbatim:
pure Python and numpy), ``kernels.fd3d`` (the FD3D step as a CUDA kernel for
sm_90a, with its plain PyTorch version), ``seismic`` (shots, the tasks A2WS
schedules), ``configs`` and ``models`` (the architecture registry and the
model families), ``serve`` (step makers and the ``ServePool`` host plane),
``launch.serve`` (the serving launcher), and the training path:
``autodiff`` (trees and ``value_and_grad``), ``optim`` (AdamW),
``checkpoint`` (the reference's on-disk format), ``data`` (the synthetic
pipeline, copied verbatim), ``runtime`` (the A2WS heterogeneous-DP trainer,
compression, the resilient driver), ``train`` (the step) and
``launch.train``; ``parallel`` (the sharding rules as DTensor placements,
collectives for ``local_map``), ``launch.mesh`` and the dry-run
(``launch.op_analysis``, ``launch.cells``, ``launch.dryrun``).  Imports
``torch`` and ``numpy``, never ``jax`` nor anything under ``repro``.
"""
