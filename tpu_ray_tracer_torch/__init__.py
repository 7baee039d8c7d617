"""tpu_ray_tracer_torch: the PyTorch/CUDA port of tpu_ray_tracer.

A differentiable ray tracer for implicit algebraic surfaces of degree <= 3,
ported slice by slice from the JAX/Pallas package beside it, which stays the
reference. The port carries scene loading, the fly camera and the render
through two hand-written CUDA kernels for Hopper: the forward
(``csrc/render_fwd.cu``), which can also save per-stage data of the
reflection chain, and the fused backward (``csrc/render_bwd.cu``), each with
a plain PyTorch version of the same math that runs on the CPU.
``render_image_kernel`` is differentiable: when a scene or camera tensor
requires grad, ``loss.backward()`` runs the backward kernel and fills the
gradients of the coefficients, colours, reflection ratios, lights,
background, field of view and camera pose. This package never imports
``jax`` or ``tpu_ray_tracer``.

Beside the kernels, the plain PyTorch pipeline (``render_image``,
``render_rays``, ``RenderConfig`` with ``FAST_CONFIG`` in f32 and
``GOLDEN_CONFIG`` in f64) renders and differentiates any scene, and gives
``render_image_kernel`` its gradient where the fused backward cannot encode
the scene (more than 31 lights, or no object). Inverse rendering
(``InverseProblem``, ``fit`` and the ``.npz`` checkpoints of
``diff/inverse.py``) takes Adam steps on scene and camera parameters
against a target frame, through the two kernels where they encode the scene
and through the pipeline otherwise; ``render_rays_soft`` (``diff/soft.py``)
is the soft-visibility render whose loss descends across root-pair events.
The NumPy oracle (``render/reference_cpu.py``), the utilities and the
command line (``python -m tpu_ray_tracer_torch.cli``) complete the
user-facing surface.
"""

from .diff.inverse import InverseProblem, fit, load_checkpoint, save_checkpoint
from .diff.soft import render_rays_soft
from .models.errors import SceneError
from .models.loader import load_from_file, load_from_string
from .models.scene import Scene, build_scene
from .ops.camera import Camera
from .render.kernel_backend import render_image_kernel
from .render.pipeline import (
    FAST_CONFIG,
    GOLDEN_CONFIG,
    RenderConfig,
    render_image,
    render_rays,
)

__all__ = [
    "Camera",
    "FAST_CONFIG",
    "GOLDEN_CONFIG",
    "InverseProblem",
    "RenderConfig",
    "Scene",
    "SceneError",
    "build_scene",
    "fit",
    "load_checkpoint",
    "load_from_file",
    "load_from_string",
    "render_image",
    "render_image_kernel",
    "render_rays",
    "render_rays_soft",
    "save_checkpoint",
]
