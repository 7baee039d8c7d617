"""tpu_ray_tracer_torch: the PyTorch/CUDA port of tpu_ray_tracer.

A differentiable ray tracer for implicit algebraic surfaces of degree <= 3,
ported slice by slice from the JAX/Pallas package beside it, which stays the
reference. This slice carries scene loading, the fly camera and the forward
render through one hand-written CUDA kernel for Hopper
(``csrc/render_fwd.cu``), with a plain PyTorch version of the same math that
runs on the CPU. This package never imports ``jax`` or ``tpu_ray_tracer``.
"""

from .models.errors import SceneError
from .models.loader import load_from_file, load_from_string
from .models.scene import Scene, build_scene
from .ops.camera import Camera
from .render.kernel_backend import render_image_kernel

__all__ = [
    "Camera",
    "Scene",
    "SceneError",
    "build_scene",
    "load_from_file",
    "load_from_string",
    "render_image_kernel",
]
