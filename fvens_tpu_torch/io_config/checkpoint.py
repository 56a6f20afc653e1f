"""Checkpoint/resume for steady and unsteady solves.

The reference parses an `init_soln_file` option but never implements it
(controlparser.hpp:24, "not implemented"); every FVENS run starts from free
stream. This module fills that gap: atomic .npz snapshots of the state plus
solver scalars, so long continuation runs survive preemption.

The port's copy of the JAX package's io_config/checkpoint.py, with the same
.npz keys (u, step, cfl, res, initres, x_*), so a checkpoint written by
either package loads in the other. A tensor state is copied to the host
first (NumPy cannot read a CUDA tensor).
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch


def save_checkpoint(path: str, u, step: int = 0, cfl: float = 0.0,
                    res: float = 0.0, initres: float = 0.0,
                    extra: dict | None = None) -> None:
    """Atomically write state + solver scalars; `u` a tensor on any device
    or an array."""
    if isinstance(u, torch.Tensor):
        u = u.detach().cpu().numpy()
    payload = {"u": np.asarray(u), "step": step, "cfl": cfl, "res": res,
               "initres": initres}
    for k, v in (extra or {}).items():
        payload["x_" + k] = np.asarray(v)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str) -> dict:
    with np.load(path) as z:
        out = {k: z[k] for k in z.files}
    out["step"] = int(out["step"])
    for k in ("cfl", "res", "initres"):
        out[k] = float(out[k])
    return out
