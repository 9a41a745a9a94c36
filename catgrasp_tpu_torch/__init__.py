"""catgrasp_tpu_torch — the PyTorch/CUDA port of ``catgrasp_tpu``.

The module layout mirrors the JAX package so every function's counterpart
sits at the same path (``catgrasp_tpu/sim/engine.py`` ->
``catgrasp_tpu_torch/sim/engine.py``).  The port imports ``torch``, ``numpy``
and ``yaml`` and nothing of the JAX package.  Pytrees become small
dataclasses of tensors, ``vmap`` a batch dimension written out, ``lax.scan``
a Python loop, and ``jax.random`` keys ``torch.Generator``s.

The three Pallas kernels (the collision gate ``box_hits``, the sphere
trace ``march_csg`` and the fused pile rollout ``rollout_fused``) are
hand-written CUDA kernels for Hopper (``csrc/``), each with a plain PyTorch
version beside its wrapper in ``ops/``: a wrapper runs the plain version
only for tensors that lie on the CPU, and launches the kernel (or raises)
for CUDA tensors.  ``parallel/`` has the device mesh, the sharded rollout
and map; ``train/trainer.py`` steps data-parallel over a mesh.

Entry points default to ``device="cuda"`` and raise when no GPU is present;
pass ``device="cpu"`` to run on the host (the tests do).
"""

__version__ = "0.1.0"
