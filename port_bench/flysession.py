"""The view traffic's generator: a seeded session of the reference viewer's
controls driving a frozen copy of the port's ``FlyCamera``
(``utils/flycam.py``, itself the reference's src/ray-tracer.cpp:24-134).

A session is a run of segments, each 0.2-1 s (the mix's ``segment_s``) of
one input held at a fixed frame time ``dt_s``: mouse-look with a constant
offset a frame (each component drawn from the mix's ``look_px``), or one of
the keys W/S/A/D/Q/Z held. After every frame yaw, pitch and each
coordinate of the position are reflected at the configuration's bounds,
which keep its surfaces in view. The session is ``session_frames`` poses
long; the window cycles through it.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

SENSITIVITY = 0.1          # reference ray-tracer.cpp:33
BASE_SPEED = 10.0          # reference ray-tracer.cpp:34
PITCH_LIMIT = 89.0         # reference ray-tracer.cpp:125-128
INPUTS = ("look", "w", "s", "a", "d", "q", "z")


@dataclasses.dataclass
class FlyCamera:
    """The reference's fly camera (a frozen copy of the port's)."""

    position: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    yaw_deg: float = 90.0
    pitch_deg: float = 0.0
    speed_multiplier: float = 1.0

    @property
    def direction(self) -> np.ndarray:
        yaw, pitch = math.radians(self.yaw_deg), math.radians(self.pitch_deg)
        return np.array([math.cos(yaw) * math.cos(pitch), math.sin(pitch),
                         math.sin(yaw) * math.cos(pitch)])

    @property
    def camera_right(self) -> np.ndarray:
        right = -np.cross(self.direction, np.array([0.0, 1.0, 0.0]))
        return right / np.linalg.norm(right)

    @property
    def movement_front(self) -> np.ndarray:
        return np.cross(self.camera_right, np.array([0.0, 1.0, 0.0]))

    def mouse_move(self, dx: float, dy: float) -> None:
        self.yaw_deg -= dx * SENSITIVITY
        self.pitch_deg -= dy * SENSITIVITY
        self.pitch_deg = max(-PITCH_LIMIT, min(PITCH_LIMIT, self.pitch_deg))

    def move(self, keys: str, dt: float) -> None:
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


def rng(seed: int) -> np.random.Generator:
    """A generator for any whole number, negative or past 64 bits."""
    words = [(abs(seed) >> (32 * i)) & 0xFFFFFFFF for i in range(max(1, (abs(seed).bit_length() + 31) // 32))]
    return np.random.default_rng(words + [int(seed < 0)])


def _reflect(value: float, lo: float, hi: float) -> float:
    """``value`` folded back into [lo, hi] at its ends."""
    span = hi - lo
    x = (value - lo) % (2 * span)
    return lo + (x if x <= span else 2 * span - x)


def session(mix: dict, view: dict, seed: int):
    """(position [S, 3], yaw [S], pitch [S]) float64 arrays of a session of
    S = ``mix["session_frames"]`` poses. ``view`` is the configuration's
    {"start": {position, yaw_deg, pitch_deg}, "bounds": {position: [[lo, hi]
    x 3], yaw_deg: [lo, hi], pitch_deg: [lo, hi]}}."""
    r = rng(seed)
    n, dt = int(mix["session_frames"]), float(mix["dt_s"])
    seg_lo, seg_hi = mix["segment_s"]
    look = float(mix["look_px"])
    start, bounds = view["start"], view["bounds"]
    cam = FlyCamera(position=np.asarray(start["position"], np.float64),
                    yaw_deg=float(start["yaw_deg"]), pitch_deg=float(start["pitch_deg"]))
    pos, yaw, pitch = np.empty((n, 3)), np.empty(n), np.empty(n)
    i = 0
    while i < n:
        frames = max(1, int(round(r.uniform(seg_lo, seg_hi) / dt)))
        kind = INPUTS[int(r.integers(len(INPUTS)))]
        dx, dy = r.uniform(-look, look, size=2)
        for _ in range(min(frames, n - i)):
            if kind == "look":
                cam.mouse_move(dx, dy)
            else:
                cam.move(kind, dt)
            cam.yaw_deg = _reflect(cam.yaw_deg, *bounds["yaw_deg"])
            cam.pitch_deg = _reflect(cam.pitch_deg, *bounds["pitch_deg"])
            cam.position = np.array([_reflect(float(cam.position[k]), *bounds["position"][k])
                                     for k in range(3)])
            pos[i], yaw[i], pitch[i] = cam.position, cam.yaw_deg, cam.pitch_deg
            i += 1
    return pos, yaw, pitch
