"""PyTorch + CUDA port of the sutro batch-inference engine, for NVIDIA
Hopper GPUs (H100).

A package of its own beside the JAX package ``sutro_tpu``, which stays
the reference: the layout and names mirror it (``models/``, ``ops/``,
``engine/``, ``telemetry/``), and nothing here imports JAX or the JAX
package. Every Pallas kernel on the engine's path is a hand-written
CUDA kernel under ``csrc/`` (built with ``nvcc`` at first use) with a
plain PyTorch version beside it in ``ops/``; a wrapper launches its
kernel on a CUDA tensor and runs the plain version on a CPU tensor.

This slice runs batch generation on dense models:
``engine.scheduler.ContinuousBatcher`` over ``engine.runner.ModelRunner``.
``ModelRunner`` runs on the GPU unless given ``device="cpu"``.
"""
