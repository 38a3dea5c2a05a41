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

from .device import DEFAULT, resolve
from .state import EngineParams, NetworkState


def numpy_leaves(obj, skip=("key",)) -> dict:
    """``{field name: numpy array}`` of a dataclass of arrays."""
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.name not in skip}


def _tensor(x, device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``, in the array's own dtype."""
    return torch.as_tensor(np.array(x), device=device)


def engine_params_from_jax(leaves: Mapping[str, np.ndarray], device=DEFAULT) -> EngineParams:
    """The port's EngineParams from the JAX one's leaves, each in its own
    dtype (float64 flows in exact mode, float32 travel times, int32
    lookbacks).  Unbatched leaves stay unbatched; a batched (randomized)
    EngineParams keeps its leading replica axis on every leaf."""
    device = resolve(device)
    return EngineParams(**{f.name: _tensor(leaves[f.name], device)
                           for f in dataclasses.fields(EngineParams)})


def network_state_from_jax(leaves: Mapping[str, np.ndarray], device=DEFAULT) -> NetworkState:
    """The port's NetworkState from a JAX one's leaves, each in its own
    dtype.

    A single-replica state (``cum_in`` of shape ``[E]``) gains a leading
    batch axis of 1; a vmapped one keeps its batch axis.  Where its
    replicas share one ``t`` that becomes the port's int, and where they
    differ the int32 ``[B]`` tensor of a per-replica-time batch.  The PRNG
    key, if present, is dropped.
    """
    device = resolve(device)
    batched = np.asarray(leaves["cum_in"]).ndim == 2
    t = np.asarray(leaves["t"]).reshape(-1)
    if (t == t[0]).all():
        t = int(t[0])
    else:
        t = torch.as_tensor(t.astype(np.int32), device=device)

    def conv(name):
        x = _tensor(leaves[name], device)
        return x if batched else x.unsqueeze(0)

    fields = [f.name for f in dataclasses.fields(NetworkState) if f.name != "t"]
    return NetworkState(t=t, **{name: conv(name) for name in fields})


def tensors_from_jax(arrays: Mapping[str, np.ndarray], device=DEFAULT) -> dict:
    """A dict of arrays (an env's observations, rewards or actions) as
    tensors on ``device``, each in its own dtype."""
    device = resolve(device)
    return {k: _tensor(v, device) for k, v in arrays.items()}


# -- flax parameter trees <-> the port's networks ------------------------------
#
# The port's modules (rl/networks.py) carry flax's layer names, so a flax
# leaf path maps onto a state_dict key; only the layout changes:
#   Dense_*  kernel [in, out]                 <-> Linear weight [out, in]
#   Conv_*   kernel [K, in, out]              <-> Conv1d weight [out, in, K]
#   OptimizedLSTMCell_*  ii,if,ig,io kernels  <-> weight_ih = cat(...).T
#                        hi,hf,hg,ho kernels  <-> weight_hh = cat(...).T,
#                        and their biases     <-> bias_hh = cat(...)
#   everything else (LayerNorm scale/bias, attention query/key/value/out in
#   DenseGeneral layout, log_std) carries over unchanged.

_GATES = ("i", "f", "g", "o")


def params_from_flax(family, tree: Mapping) -> dict:
    """The ``state_dict`` of the module ``family`` (an ``nn.Module`` of
    ``rl.networks``) holding the flax parameter tree ``tree`` (numpy
    leaves, with or without the top-level ``"params"``).  Raises if the
    tree's layers do not fill the module exactly."""
    tree = tree.get("params", tree)
    out = {}

    def walk(node, prefix):
        for name, sub in node.items():
            key = prefix + name
            if name.startswith("Dense_"):
                out[key + ".weight"] = np.asarray(sub["kernel"]).T
                if "bias" in sub:
                    out[key + ".bias"] = np.asarray(sub["bias"])
            elif name.startswith("Conv_"):
                out[key + ".weight"] = np.asarray(sub["kernel"]).transpose(2, 1, 0)
                out[key + ".bias"] = np.asarray(sub["bias"])
            elif name.startswith("OptimizedLSTMCell_"):
                cat = np.concatenate
                out[key + ".weight_ih"] = cat([sub[f"i{g}"]["kernel"] for g in _GATES], -1).T
                out[key + ".weight_hh"] = cat([sub[f"h{g}"]["kernel"] for g in _GATES], -1).T
                out[key + ".bias_hh"] = cat([sub[f"h{g}"]["bias"] for g in _GATES])
            elif isinstance(sub, Mapping):
                walk(sub, key + ".")
            else:
                out[key] = np.asarray(sub)

    walk(tree, "")
    want = family.state_dict()
    if out.keys() != want.keys():
        raise ValueError(f"flax tree does not fit {type(family).__name__}: missing "
                         f"{sorted(want.keys() - out.keys())}, extra "
                         f"{sorted(out.keys() - want.keys())}")
    sd = {}
    for k, v in out.items():
        if tuple(v.shape) != tuple(want[k].shape):
            raise ValueError(f"{k}: flax shape {v.shape} != {tuple(want[k].shape)}")
        sd[k] = torch.from_numpy(np.array(v))
    return sd


def params_to_flax(module) -> dict:
    """The flax parameter tree ``{"params": {...}}`` of a module of
    ``rl.networks`` (or of its ``state_dict``): the same names, shapes and
    dtypes as flax's ``init`` gives, as numpy arrays."""
    sd = module.state_dict() if hasattr(module, "state_dict") else module
    tree: dict = {}
    for key, t in sd.items():
        a = t.detach().cpu().numpy()
        *path, leaf = key.split(".")
        layer = path[-1] if path else ""
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        if layer.startswith("Dense_"):
            node["kernel" if leaf == "weight" else "bias"] = a.T if leaf == "weight" else a
        elif layer.startswith("Conv_"):
            node["kernel" if leaf == "weight" else "bias"] = (
                a.transpose(2, 1, 0) if leaf == "weight" else a)
        elif layer.startswith("OptimizedLSTMCell_"):
            parts = np.split(a.T if leaf != "bias_hh" else a, 4, axis=-1)
            for g, part in zip(_GATES, parts):
                if leaf == "weight_ih":
                    node.setdefault(f"i{g}", {})["kernel"] = part
                elif leaf == "weight_hh":
                    node.setdefault(f"h{g}", {})["kernel"] = part
                else:
                    node.setdefault(f"h{g}", {})["bias"] = part
        else:
            node[leaf] = a
    return {"params": _copy_leaves(tree)}


def _copy_leaves(node):
    """Contiguous copies of every leaf (so transposed views pickle as flax
    arrays and share no memory with the module)."""
    if isinstance(node, dict):
        return {k: _copy_leaves(v) for k, v in node.items()}
    return np.ascontiguousarray(node).copy()
