"""Fly camera: Euler angles -> camera-to-world frame -> per-pixel rays.

Counterpart of ``tpu_ray_tracer/ops/camera.py``; the reference camera
(src/ray-tracer.cpp:24-58):

* ``direction = (cos yaw cos pitch, sin pitch, sin yaw cos pitch)``, yaw and
  pitch in degrees (initial yaw 90, pitch 0);
* ``camera_matrix = inverse(lookAt(position, position - direction, up))``
  with ``up = (0, 1, 0)``: rotation columns (right, up', direction);
* ray generation (src/update-cpu.cpp:84-89): for pixel (x, y),
  ndc = (p + 0.5) / dim, camera-space target
  ((2 ndc_x - 1) * aspect * tan_fov, (2 ndc_y - 1) * tan_fov, 1),
  dir = normalize(R @ target). Row y = 0 is the bottom of the image.

Every function computes in the dtype of its inputs.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Camera:
    position: torch.Tensor   # [3]
    yaw_deg: torch.Tensor    # 0-d
    pitch_deg: torch.Tensor  # 0-d

    @staticmethod
    def initial(dtype=torch.float64, device="cuda") -> "Camera":
        """Reference initial pose: position (0,0,0), yaw 90, pitch 0
        (reference: src/ray-tracer.cpp:25, 31-32), on the card unless
        ``device`` names another; without a card the default raises, as the
        loaders' does (``utils/device.resolve_device``)."""
        device = resolve_device(device)
        return Camera(
            position=torch.zeros(3, dtype=dtype, device=device),
            yaw_deg=torch.full((), 90.0, dtype=dtype, device=device),
            pitch_deg=torch.zeros((), dtype=dtype, device=device),
        )

    def to(self, dtype=None, device=None) -> "Camera":
        return Camera(*(t.to(device=device, dtype=dtype)
                        for t in (self.position, self.yaw_deg, self.pitch_deg)))


def _deg2rad(x: torch.Tensor) -> torch.Tensor:
    # one multiply by pi/180 rounded to x's dtype, as jnp.deg2rad does (a
    # Python scalar operand is cast to the tensor's dtype)
    return x * (math.pi / 180.0)


def view_direction(yaw_deg: torch.Tensor, pitch_deg: torch.Tensor) -> torch.Tensor:
    """Euler angles (degrees) -> view direction (reference: src/ray-tracer.cpp:44-49)."""
    yaw = _deg2rad(yaw_deg)
    pitch = _deg2rad(pitch_deg)
    return torch.stack(
        [torch.cos(yaw) * torch.cos(pitch), torch.sin(pitch),
         torch.sin(yaw) * torch.cos(pitch)],
        dim=-1,
    )


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.sqrt((v * v).sum(-1, keepdim=True))


def camera_frame(camera: Camera):
    """Camera-to-world rotation (3x3, columns right/up/forward-into-scene) and
    the eye position.

    Equal to inverse(lookAt(position, position - direction, up))
    (reference: src/ray-tracer.cpp:54-58): with f = normalize(-direction),
    s = normalize(cross(f, up)) and u = cross(s, f), the inverse has columns
    (s, u, -f) and translation eye.
    """
    d = view_direction(camera.yaw_deg, camera.pitch_deg)
    f = _normalize(-d)
    # (0, 1, 0) written on the device: a copy from the host could not be
    # captured into a CUDA graph
    up = torch.zeros(3, dtype=d.dtype, device=d.device)
    up.narrow(0, 1, 1).fill_(1.0)
    s = _normalize(torch.linalg.cross(f, up))
    u = torch.linalg.cross(s, f)
    rotation = torch.stack([s, u, -f], dim=-1)  # columns
    return rotation, camera.position


def camera_matrix(camera: Camera) -> torch.Tensor:
    """Full 4x4 camera-to-world matrix."""
    rotation, eye = camera_frame(camera)
    mat = torch.eye(4, dtype=rotation.dtype, device=rotation.device)
    mat[:3, :3] = rotation
    mat[:3, 3] = eye
    return mat


def pixel_directions(rotation: torch.Tensor, width: int, height: int,
                     aspect_ratio: float, tan_half_fov, y0: int = 0,
                     rows: int | None = None) -> torch.Tensor:
    """Unit ray directions [rows, width, 3] for image rows [y0, y0 + rows);
    row 0 of the output is image row y0 (image row 0 = bottom of frame)."""
    if rows is None:
        rows = height
    dtype, device = rotation.dtype, rotation.device
    tan_half_fov = torch.as_tensor(tan_half_fov, dtype=dtype, device=device)
    xs = (torch.arange(width, dtype=dtype, device=device) + 0.5) / width
    ys = (torch.arange(rows, dtype=dtype, device=device) + (y0 + 0.5)) / height
    cam_x = (2.0 * xs - 1.0) * aspect_ratio * tan_half_fov  # [W]
    cam_y = (2.0 * ys - 1.0) * tan_half_fov              # [rows]
    # target = R @ (cx, cy, 1) = cx * col0 + cy * col1 + col2
    target = (cam_x[None, :, None] * rotation[:, 0]
              + cam_y[:, None, None] * rotation[:, 1]
              + rotation[:, 2])
    return _normalize(target)
