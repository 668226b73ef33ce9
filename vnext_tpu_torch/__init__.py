"""vnext_tpu_torch: the PyTorch + CUDA port of vnext_tpu for NVIDIA Hopper.

Mirrors the JAX package's layout (``ops/``, ``models/``, ``models/backbones/``,
``tracking/``, ``engine/``, ``evaluation/``, ``checkpoint/``). The kernels the
JAX package wrote in Pallas for the TPU are hand-written CUDA C++ for ``sm_90a``
under ``csrc/``, built on first use by ``_build.py``; each has a plain PyTorch
twin in the same module, which is what runs on CPU tensors.

The first slice is IDOL-R50 clip inference: ``models.idol.build_idol_model`` and
``engine.vis_inference.IDOLVideoInference``. This package imports torch and
never jax.
"""

__version__ = "0.1.0"
