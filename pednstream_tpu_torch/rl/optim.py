"""A functional Adam over a parameter list, with optax's arithmetic.

``adam_update`` is ``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8, bias
correction), optionally after ``optax.clip_by_global_norm(max_norm)``,
which rescales by ``max_norm / g_norm`` only when ``g_norm >= max_norm``
(``torch.nn.utils.clip_grad_norm_`` adds 1e-6 and clamps instead).  The
step count lives on the device and an optional ``keep`` flag (a bool
tensor) leaves parameters and state unchanged where it is true, so a
masked update (the batched trainer's KL early stop) needs no host sync.
"""

from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch


@dataclass
class AdamState:
    count: torch.Tensor  # int32 scalar, optax's ScaleByAdamState.count
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def adam_init(params: Sequence[torch.Tensor]) -> AdamState:
    params = list(params)
    dev = params[0].device
    return AdamState(count=torch.zeros((), dtype=torch.int32, device=dev),
                     mu=[torch.zeros_like(p) for p in params],
                     nu=[torch.zeros_like(p) for p in params])


@torch.no_grad()
def adam_update(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                state: AdamState, lr: float, max_norm: Optional[float] = None,
                keep: Optional[torch.Tensor] = None, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8) -> None:
    """One optimizer step applied to ``params`` and ``state`` in place."""
    params, grads = list(params), list(grads)
    if max_norm is not None:
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        trigger = g_norm < max_norm
        grads = [torch.where(trigger, g, (g / g_norm) * max_norm) for g in grads]
    count = state.count + 1
    n = count.to(params[0].dtype)
    bc1 = 1 - torch.pow(b1, n)  # b1 ** count in the parameters' dtype, as optax
    bc2 = 1 - torch.pow(b2, n)
    for i, (p, g) in enumerate(zip(params, grads)):
        mu = (1 - b1) * g + b1 * state.mu[i]
        nu = (1 - b2) * (g * g) + b2 * state.nu[i]
        new_p = p + (-lr) * ((mu / bc1) / (torch.sqrt(nu / bc2) + eps))
        if keep is not None:
            new_p = torch.where(keep, p, new_p)
            mu = torch.where(keep, state.mu[i], mu)
            nu = torch.where(keep, state.nu[i], nu)
        p.copy_(new_p)
        state.mu[i] = mu
        state.nu[i] = nu
    state.count = count if keep is None else torch.where(keep, state.count, count)
