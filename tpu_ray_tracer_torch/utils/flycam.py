"""Fly-camera controller: the reference's interactive input semantics as a
headless state machine.

Counterpart of ``tpu_ray_tracer/utils/flycam.py``.

Replicates reference src/ray-tracer.cpp:24-134 exactly:

* Euler state: yaw (init 90), pitch (init 0, clamped to +-89 by mouse-look).
* ``update_direction``: direction = (cos yaw cos pitch, sin pitch,
  sin yaw cos pitch); camera_right = -normalize(cross(direction, up));
  movement_front = cross(camera_right, up) (horizontal motion only).
* Keys: W/S along movement_front, D/A along camera_right, Q/Z vertical;
  speed = base(10) * multiplier * dt; scroll multiplies the multiplier by
  1.1^dy; mouse-look sensitivity 0.1 with yaw/pitch DEcreasing for positive
  offsets.

Drives the offline ``animate`` path and any future interactive viewer; being
pure state -> state it is unit-testable without a window system.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

SENSITIVITY = 0.1          # reference ray-tracer.cpp:33
BASE_SPEED = 10.0          # reference ray-tracer.cpp:34
SCROLL_MULT = 1.1          # reference ray-tracer.cpp:35
PITCH_LIMIT = 89.0         # reference ray-tracer.cpp:125-128


@dataclasses.dataclass
class FlyCamera:
    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, dtype=np.float64)
    )
    yaw_deg: float = 90.0
    pitch_deg: float = 0.0
    speed_multiplier: float = 1.0

    # --- derived frame (reference update_direction, :44-52) ---

    @property
    def direction(self) -> np.ndarray:
        yaw = math.radians(self.yaw_deg)
        pitch = math.radians(self.pitch_deg)
        return np.array([
            math.cos(yaw) * math.cos(pitch),
            math.sin(pitch),
            math.sin(yaw) * math.cos(pitch),
        ])

    @property
    def camera_right(self) -> np.ndarray:
        up = np.array([0.0, 1.0, 0.0])
        right = -np.cross(self.direction, up)
        return right / np.linalg.norm(right)

    @property
    def movement_front(self) -> np.ndarray:
        up = np.array([0.0, 1.0, 0.0])
        return np.cross(self.camera_right, up)

    # --- inputs ---

    def mouse_move(self, dx: float, dy: float) -> None:
        """Mouse-look (reference mouse_callback, :106-129): positive offsets
        DEcrease yaw/pitch; pitch clamped to +-89."""
        self.yaw_deg -= dx * SENSITIVITY
        self.pitch_deg -= dy * SENSITIVITY
        self.pitch_deg = max(-PITCH_LIMIT, min(PITCH_LIMIT, self.pitch_deg))

    def scroll(self, dy: float) -> None:
        """Speed multiplier x= 1.1^dy (reference scroll_callback, :131-134)."""
        self.speed_multiplier *= SCROLL_MULT ** dy

    def move(self, keys: str, dt: float) -> None:
        """Apply held keys for a frame of duration dt (reference
        process_inputs, :60-104). `keys` is any subset of "wsadqz"."""
        step = BASE_SPEED * self.speed_multiplier * dt
        if "w" in keys:
            self.position = self.position + self.movement_front * step
        if "s" in keys:
            self.position = self.position - self.movement_front * step
        if "d" in keys:
            self.position = self.position + self.camera_right * step
        if "a" in keys:
            self.position = self.position - self.camera_right * step
        if "q" in keys:
            self.position = self.position + np.array([0.0, step, 0.0])
        if "z" in keys:
            self.position = self.position - np.array([0.0, step, 0.0])

    # --- export ---

    def to_camera(self, dtype="float32", device="cuda"):
        """Snapshot as the renderer's differentiable ``Camera`` on ``device``
        (the GPU unless the caller asks for another; raises without one)."""
        import torch

        from ..models.scene import resolve_device
        from ..ops.camera import Camera

        dt, dev = getattr(torch, dtype), resolve_device(device)
        return Camera(
            position=torch.as_tensor(self.position, dtype=dt, device=dev),
            yaw_deg=torch.tensor(self.yaw_deg, dtype=dt, device=dev),
            pitch_deg=torch.tensor(self.pitch_deg, dtype=dt, device=dev),
        )
