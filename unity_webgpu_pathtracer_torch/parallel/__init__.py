"""Multi-GPU rendering: film tiling and sample sharding over
``torch.distributed`` (``parallel/`` of the reference)."""

from unity_webgpu_pathtracer_torch.parallel.film_tiling import (  # noqa: F401
    Mesh,
    make_mesh,
    multichip_fused_pass,
    multichip_render_pass,
    multichip_samples_per_pass,
)
