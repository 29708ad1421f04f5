"""PyTorch + CUDA port of the progressive Monte-Carlo path tracer.

The JAX package ``unity_webgpu_pathtracer_tpu`` is the reference this port
is held against; this package imports ``torch`` and ``numpy`` and never
``jax``.  Module names mirror the reference's, so each module's
counterpart is easy to find; the two Pallas kernels of the main path are
hand-written CUDA kernels here (``ops/cuda_arrival.py``,
``ops/cuda_transition.py``, sources under ``csrc/``), each with a plain
PyTorch twin that runs when the tensors lie on the CPU.

The main path ported so far: ``models.benchmark.million_triangle_scene``
-> ``Scene.build("wide16")`` -> ``render.fused.fused_pass_with_stats``
(wide16 traversal + gather-free prestep, HDRI environment NEE, paired f16
attribute rows, record film, Russian roulette), driven by
:class:`unity_webgpu_pathtracer_torch.api.Renderer`; beside it the
reference's megakernel and wavefront integrators (``render/integrator.py``,
``render/wavefront.py``, tracing through K1), its OBJ and glTF loaders and
film checkpoints.
"""

__version__ = "0.1.0"

from unity_webgpu_pathtracer_torch.config import RenderConfig, RenderParams  # noqa: F401

__all__ = ["RenderConfig", "RenderParams", "__version__"]
