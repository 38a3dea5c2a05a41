"""Carry engine parameters and state over from the JAX package.

The JAX leaves arrive as a ``{name: numpy array}`` mapping
(:func:`numpy_leaves` makes one from any dataclass of arrays, a JAX
``EngineParams`` or ``NetworkState`` included, without importing JAX).
The converters give the port's dataclasses on ``device``, each leaf in the
JAX leaf's dtype, so both engines can be stepped from the same state.
"""

import dataclasses
from typing import Mapping

import numpy as np
import torch

from .state import EngineParams, NetworkState


def numpy_leaves(obj, skip=("key",)) -> dict:
    """``{field name: numpy array}`` of a dataclass of arrays."""
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.name not in skip}


def _tensor(x, device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``, in the array's own dtype."""
    return torch.as_tensor(np.array(x), device=device)


def engine_params_from_jax(leaves: Mapping[str, np.ndarray], device="cpu") -> EngineParams:
    """The port's EngineParams from the JAX one's leaves, each in its own
    dtype (float64 flows in exact mode, float32 travel times, int32
    lookbacks).  Unbatched leaves stay unbatched; a batched (randomized)
    EngineParams keeps its leading replica axis on every leaf."""
    return EngineParams(**{f.name: _tensor(leaves[f.name], device)
                           for f in dataclasses.fields(EngineParams)})


def network_state_from_jax(leaves: Mapping[str, np.ndarray], device="cpu") -> NetworkState:
    """The port's NetworkState from a JAX one's leaves, each in its own
    dtype.

    A single-replica state (``cum_in`` of shape ``[E]``) gains a leading
    batch axis of 1; a vmapped one keeps its batch axis and must share one
    ``t``.  The PRNG key, if present, is dropped.
    """
    batched = np.asarray(leaves["cum_in"]).ndim == 2
    t = np.asarray(leaves["t"]).reshape(-1)
    if not (t == t[0]).all():
        raise ValueError(f"replicas are not in lockstep: t = {t.tolist()}")

    def conv(name):
        x = _tensor(leaves[name], device)
        return x if batched else x.unsqueeze(0)

    fields = [f.name for f in dataclasses.fields(NetworkState) if f.name != "t"]
    return NetworkState(t=int(t[0]), **{name: conv(name) for name in fields})


def tensors_from_jax(arrays: Mapping[str, np.ndarray], device="cpu") -> dict:
    """A dict of arrays (an env's observations, rewards or actions) as
    tensors on ``device``, each in its own dtype."""
    return {k: _tensor(v, device) for k, v in arrays.items()}
