"""PyTorch + CUDA port of :mod:`crosscoder_tpu` for one NVIDIA H100.

Same module names and paths as the JAX package, so each counterpart is
found by name. The port imports ``torch`` and numpy only, never ``jax``
nor anything of ``crosscoder_tpu``. Public entry points run on ``cuda``
unless the caller passes ``device="cpu"``; the hand-written Hopper kernels
under ``csrc/`` are built with ``nvcc`` at first use
(:mod:`crosscoder_tpu_torch.ops._build`).
"""
