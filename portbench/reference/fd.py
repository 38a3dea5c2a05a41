"""Vectorized fundamental diagrams on tensors (``pednstream_tpu/fd.py``).

All three FD types are evaluated branch-free over the link axis with
per-link integer codes (:data:`FD_TYPES`).  Float32 staging follows the
JAX module: the reference computes FD speeds from float32 densities with
Python-float parameters, so every subexpression stays float32, except the
Yperman coefficient and the Smulders constants, which are computed in the
parameters' own dtype and then cast.
"""

import torch

from .topology import FD_TYPES

_f32 = torch.float32


def speed_from_density(k_eff32, v_f, k_critical, k_jam, fd_type):
    """Float32 speed for float32 effective density ``k_eff32`` ([..., E]);
    ``v_f``/``k_critical``/``k_jam`` are [E] parameters in the flow dtype
    and ``fd_type`` the [E] FD codes.  Greenshields / Yperman-triangular /
    Smulders per functions.py:112-128."""
    vf32 = v_f.to(_f32)
    kc32 = k_critical.to(_f32)
    kj32 = k_jam.to(_f32)
    below = k_eff32 <= kc32
    safe_k = torch.where(k_eff32 > 0, k_eff32, 1.0)

    # greenshields: -v_f * (k_eff - k_jam) / (k_jam - k_critical)
    den32 = (k_jam - k_critical).to(_f32)
    v_green = torch.where(
        below, vf32, torch.clamp((-vf32 * (k_eff32 - kj32)) / den32, min=0.0)
    )
    # yperman: coefficient in the parameter dtype, then cast
    coef32 = ((k_critical * v_f) / (k_jam - k_critical)).to(_f32)
    v_yper = torch.where(
        below, vf32, torch.clamp(coef32 * (kj32 / safe_k - 1.0), min=0.0)
    )
    # smulders: u0 = v_f, gamma = u0 * k_critical (functions.py:107-108)
    gamma32 = (v_f * k_critical).to(_f32)
    inv_kjam32 = (1.0 / k_jam).to(_f32)
    v_smul = torch.where(
        below,
        vf32 * (1.0 - k_eff32 / kj32),
        torch.clamp(gamma32 * (1.0 / safe_k - inv_kjam32), min=0.0),
    )

    v = torch.where(
        fd_type == FD_TYPES["greenshields"],
        v_green,
        torch.where(fd_type == FD_TYPES["yperman"], v_yper, v_smul),
    )
    return v.to(_f32)


def link_flow_kv(density, speed):
    """q = k * v (functions.py:97-101)."""
    return density * speed
