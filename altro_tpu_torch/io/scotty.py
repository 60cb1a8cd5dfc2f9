"""Reference-trajectory IO (PyTorch port; numpy only).

Counterpart: altro_tpu/io/scotty.py (`load_scotty`, `synthetic_scotty`).
Both packages read the same vendored fixture, `data/scotty.npz`.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple

import numpy as np

_DATA = os.path.join(os.path.dirname(__file__), "..", "..", "data")
DEFAULT_PATHS = (
    os.path.join(_DATA, "scotty.json"),
    os.path.join(_DATA, "scotty.npz"),
)


class ReferenceTrajectory(NamedTuple):
    N: int  # number of segments
    tf: float
    h: float
    x: np.ndarray  # [N+1, n]
    u: np.ndarray  # [N+1, m]


def load_scotty(path: str | None = None) -> ReferenceTrajectory:
    if path is None:
        path = next((p for p in DEFAULT_PATHS if os.path.exists(p)), None)
    if path is None or not os.path.exists(path):
        raise FileNotFoundError("scotty fixture not found; use synthetic_scotty()")
    if path.endswith(".npz"):
        data = dict(np.load(path))
    else:
        with open(path) as f:
            data = json.load(f)
    N = int(data["N"]) - 1
    tf = float(data["tf"])
    x = np.asarray(data["state_trajectory"], dtype=np.float64)
    u = np.asarray(data["input_trajectory"], dtype=np.float64)
    return ReferenceTrajectory(N=N, tf=tf, h=tf / N, x=x, u=u)


def synthetic_scotty(N: int = 500, tf: float = 50.0, scale: float = 30.0) -> ReferenceTrajectory:
    """Figure-eight bicycle reference with consistent headings/speeds."""
    h = tf / N
    t = np.linspace(0.0, 2.0 * np.pi, N + 1)
    px = scale * np.sin(t)
    py = 0.5 * scale * np.sin(2.0 * t)
    dx = np.gradient(px, tf / N)
    dy = np.gradient(py, tf / N)
    theta = np.unwrap(np.arctan2(dy, dx))
    speed = np.sqrt(dx * dx + dy * dy)
    ddx = np.gradient(dx, tf / N)
    ddy = np.gradient(dy, tf / N)
    curv = (dx * ddy - dy * ddx) / np.maximum(speed**3, 1e-6)
    delta = np.arctan(2.7 * curv)
    delta_dot = np.gradient(delta, tf / N)
    x = np.stack([px, py, theta, delta], axis=1)
    u = np.stack([speed, delta_dot], axis=1)
    return ReferenceTrajectory(N=N, tf=tf, h=h, x=x, u=u)
