"""Checkpoint / resume.

The counterpart of ``tpufem.checkpoint``.  A simulation state is a dict of
tensors (nested dicts allowed) and the steppers are functions of the state
alone, so a resumed run continues exactly where the saved one stopped.

Format: tpufem's ``.npz`` layout (flattened key paths ``a/b``, the step
under ``__step__``), so a checkpoint written by either package loads in
the other; :func:`save_torch`/:func:`load_torch` keep a state in
``torch.save``'s format (tpufem's ``save_orbax``/``load_orbax``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tpufem_torch import config as tconfig
from tpufem_torch.metrics import to_host


def _flatten(state: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in state.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = to_host(v)
    return out


def save_state(path: str, state: dict, step: int | None = None) -> str:
    """Write a state (dict of tensors / nested dicts) to ``path`` (.npz);
    bf16 tensors are stored as float32."""
    flat = _flatten(state)
    if step is not None:
        flat["__step__"] = np.asarray(step)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)
    return path


def load_state(path: str, dtype: torch.dtype | None = None, device=None):
    """→ (state dict of tensors on ``device``, step or None); nested keys
    (``a/b``) are nested again, floating arrays cast to ``dtype`` if given.
    ``device`` as :func:`tpufem_torch.config.device` (None: the card)."""
    dev = tconfig.device(device)
    state: dict = {}
    step = None
    with np.load(path) as data:
        for key in data.files:
            if key == "__step__":
                step = int(data[key])
                continue
            parts = key.split("/")
            d = state
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            t = torch.as_tensor(data[key], device=dev)
            if dtype is not None and t.is_floating_point():
                t = t.to(dtype)
            d[parts[-1]] = t
    return state, step


def save_torch(path: str, state: dict) -> str:
    """Write a state in ``torch.save``'s format (tensors keep their device
    type and dtype)."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(state, path)
    return path


def load_torch(path: str, device=None) -> dict:
    """A state written by :func:`save_torch`, on ``device`` (None: the card)."""
    return torch.load(os.path.abspath(path), map_location=tconfig.device(device),
                      weights_only=True)


def checkpointed_run(problem, total_steps: int, every: int, directory: str,
                     state: dict | None = None):
    """Run a Stokes problem, writing a checkpoint every ``every`` steps.

    Returns (final state, [checkpoint paths]).  Resume with
    ``load_state(path, device=...)`` → ``stokes.run(problem, steps, state=state)``."""
    from tpufem_torch.workloads import stokes

    if state is None:
        state = stokes.initial_state(problem)
    paths = []
    done = 0
    while done < total_steps:
        chunk = min(every, total_steps - done)
        state, _ = stokes.run(problem, steps=chunk, state=state)
        done += chunk
        path = os.path.join(directory, f"ckpt_{done:08d}.npz")
        paths.append(save_state(path, state, step=done))
    return state, paths
