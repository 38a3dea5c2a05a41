"""Mid-run engine state snapshot and restore (the counterpart of
``pednstream_tpu/utils/checkpoint.py``).

The whole :class:`NetworkState` goes into one ``.npz``, every leaf under
its field name and in its own dtype, ``t`` included in either form (the
shared int or the per-replica int32 ``[B]``), so a long simulation or a
training run restarts exactly where it stopped, on either device.  There
is no PRNG key leaf: a stochastic run also keeps its ``torch.Generator``'s
state (``get_state``/``set_state``).
"""

import dataclasses

import numpy as np
import torch

from ..device import DEFAULT, resolve
from ..state import NetworkState


def save_engine_state(state: NetworkState, path: str) -> None:
    """Write every leaf of ``state`` to the ``.npz`` at ``path``."""
    arrays = {}
    for f in dataclasses.fields(state):
        x = getattr(state, f.name)
        arrays[f.name] = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    np.savez_compressed(path, **arrays)


def load_engine_state(path: str, like: NetworkState, device=DEFAULT) -> NetworkState:
    """Restore a snapshot onto ``device``; ``like`` supplies the expected
    shapes and dtypes (use ``scenario.init_state(batch)``).  ``t`` comes
    back in the form it was saved in."""
    device = resolve(device)
    leaves = {}
    with np.load(path) as data:
        names = {f.name for f in dataclasses.fields(NetworkState)}
        if set(data.files) != names:
            raise ValueError(f"snapshot holds {sorted(data.files)}, expected {sorted(names)}: "
                             "was it saved by another version?")
        for name in names - {"t"}:
            arr, ref = data[name], getattr(like, name)
            if arr.shape != tuple(ref.shape):
                raise ValueError(f"{name}: shape {arr.shape} != expected {tuple(ref.shape)}; "
                                 "was it saved from a different scenario?")
            leaves[name] = torch.as_tensor(arr, device=device).to(ref.dtype)
        t = data["t"]
    if t.ndim == 0:
        return NetworkState(t=int(t), **leaves)
    if t.shape != (like.batch,):
        raise ValueError(f"t: shape {t.shape} != expected ({like.batch},)")
    return NetworkState(t=torch.as_tensor(t.astype(np.int32), device=device), **leaves)
