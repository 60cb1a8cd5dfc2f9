"""Checkpoint / resume for solver state (PyTorch port).

Counterpart: altro_tpu/checkpoint.py (`save_state`, `load_state`): the
SolverState (trajectory, duals, penalty, gains, regularization) to and
from a .npz archive, enough to resume a warm-started solve exactly.
Archives written by either package load in the other (the same keys).
"""

from __future__ import annotations

import numpy as np
import torch

from altro_tpu_torch.solver import SolverState

__all__ = ["save_state", "load_state"]

_FIELDS = ["x", "u", "y", "rho", "K", "d", "P", "p", "reg"]


def save_state(path: str, state: SolverState) -> None:
    arrays = {f: getattr(state, f).detach().cpu().numpy() for f in _FIELDS}
    for i, zj in enumerate(state.z):
        arrays[f"z_{i}"] = zj.detach().cpu().numpy()
    arrays["_num_z"] = np.asarray(len(state.z))
    np.savez(path, **arrays)


def load_state(path: str, dtype=None, device="cuda") -> SolverState:
    """The archived state as tensors on `device` (in `dtype` when given,
    else the archive's): the card by default, like the port's other entry
    points (JAX's puts the arrays on its default device). Without a card,
    pass device="cpu"; a CUDA device is not quietly replaced by the CPU."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"load_state: device {device!r} asked for and no CUDA device is "
                           "available; pass device='cpu'")
    data = np.load(path)

    def conv(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    z = tuple(conv(data[f"z_{i}"]) for i in range(int(data["_num_z"])))
    return SolverState(z=z, **{f: conv(data[f]) for f in _FIELDS})
