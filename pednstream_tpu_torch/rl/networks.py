"""Policy / value network families as ``nn.Module`` (the counterpart of
``pednstream_tpu/rl/networks.py``).

Every module takes a leading batch axis where the JAX package ``vmap``s a
per-replica flax module: ``[B, L, F]`` per-link observations, ``[B, D]``
flat ones, ``[B, K, D]`` frame stacks.  Recurrent state is an explicit
carry in and out, in flax's order ``(c, h)``, each ``[B, L, H]`` (per-link
torsos) or ``[B, H]``; the non-recurrent families pass their carry
through.  Policies return ``mu`` and ``log_std`` of the same shape.

Submodules and parameters carry the flax names (``Dense_0``,
``OptimizedLSTMCell_0``, ``log_std``, ...), in flax's construction order,
so ``interop.params_from_flax``/``params_to_flax`` map one tree onto the
other leaf for leaf.  ``init_flax_`` draws initial weights from a
``torch.Generator`` with flax's initializers (truncated LeCun normal,
orthogonal recurrent kernels, zero biases).
"""

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

Carry = Tuple[torch.Tensor, torch.Tensor]


class OptimizedLSTMCell(nn.Module):
    """flax ``OptimizedLSTMCell``: gates ``i, f, g, o`` from input kernels
    without bias plus hidden kernels with bias; ``c' = f c + i g``,
    ``h' = o tanh(c')``.  ``weight_ih``/``weight_hh`` stack the four gate
    kernels, transposed, as ``nn.LSTMCell`` does."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.weight_ih = nn.Parameter(torch.zeros(4 * hidden, in_features))
        self.weight_hh = nn.Parameter(torch.zeros(4 * hidden, hidden))
        self.bias_hh = nn.Parameter(torch.zeros(4 * hidden))

    def forward(self, carry: Carry, x: torch.Tensor):
        c, h = carry
        dense_h = h @ self.weight_hh.T + self.bias_hh
        dense_i = x @ self.weight_ih.T
        i, f, g, o = (dense_h + dense_i).chunk(4, dim=-1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        return (new_c, new_h), new_h


def zero_carry(lead: tuple, hidden: int, device=None) -> Carry:
    """The flax LSTM initial carry: zeros ``(c, h)`` of shape ``lead + (hidden,)``."""
    z = torch.zeros(lead + (hidden,), device=device)
    return z, z.clone()


class DenseGeneral(nn.Module):
    """A flax ``DenseGeneral`` kept in flax's layout: ``kernel`` of shape
    ``in_shape + out_shape``, ``bias`` of ``out_shape``."""

    def __init__(self, in_shape: tuple, out_shape: tuple):
        super().__init__()
        self.n_in = len(in_shape)
        self.kernel = nn.Parameter(torch.zeros(in_shape + out_shape))
        self.bias = nn.Parameter(torch.zeros(out_shape))

    def forward(self, x):
        dims = list(range(-self.n_in, 0))
        return torch.tensordot(x, self.kernel, dims=(dims, list(range(self.n_in)))) + self.bias


class MultiHeadDotProductAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` over ``[B, L, D]`` with q = k =
    v = the input: per-head projections, queries scaled by
    ``1/sqrt(head_dim)``, softmax over keys, output projection."""

    def __init__(self, features: int, num_heads: int, qkv_features: int):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = qkv_features // num_heads
        shape = (num_heads, self.head_dim)
        self.query = DenseGeneral((features,), shape)
        self.key = DenseGeneral((features,), shape)
        self.value = DenseGeneral((features,), shape)
        self.out = DenseGeneral(shape, (features,))

    def forward(self, x):
        q = self.query(x) / math.sqrt(self.head_dim)  # [B, L, n, d]
        k, v = self.key(x), self.value(x)
        w = torch.softmax(torch.einsum("bqnd,bknd->bnqk", q, k), dim=-1)
        return self.out(torch.einsum("bnqk,bknd->bqnd", w, v))


class LayerNorm(nn.Module):
    """flax ``LayerNorm``: epsilon 1e-6 and the fast variance
    ``max(E[x^2] - E[x]^2, 0)``."""

    def __init__(self, features: int, epsilon: float = 1e-6):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        return (x - mean) * (torch.rsqrt(var + self.epsilon) * self.scale) + self.bias


def _log_std(n: int) -> nn.Parameter:
    return nn.Parameter(torch.full((n,), -0.5))


class AttentionTorso(nn.Module):
    """Per-link LSTM + link-to-link attention (PPO_backup.py:597-680)."""

    def __init__(self, features: int, hidden_dim: int = 64, num_heads: int = 2):
        super().__init__()
        self.Dense_0 = nn.Linear(features, hidden_dim)
        self.OptimizedLSTMCell_0 = OptimizedLSTMCell(hidden_dim, hidden_dim)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            hidden_dim, num_heads, hidden_dim)
        self.LayerNorm_0 = LayerNorm(hidden_dim)

    def forward(self, obs_links, carry):  # [B, L, F]; carry [B, L, H] each
        x = torch.tanh(self.Dense_0(obs_links))
        new_carry, h = self.OptimizedLSTMCell_0(carry, x)  # shared cell over links
        att = self.MultiHeadDotProductAttention_0(h)
        return self.LayerNorm_0(h + att), new_carry

    @staticmethod
    def initial_carry(batch: int, num_links: int, hidden_dim: int = 64, device=None) -> Carry:
        return zero_carry((batch, num_links), hidden_dim, device)


class AttentionPolicy(nn.Module):
    """Per-link delta-action Gaussian policy."""

    def __init__(self, num_links: int, features: int, hidden_dim: int = 64,
                 num_heads: int = 2):
        super().__init__()
        self.AttentionTorso_0 = AttentionTorso(features, hidden_dim, num_heads)
        self.Dense_0 = nn.Linear(hidden_dim, 1)
        self.log_std = _log_std(num_links)

    def forward(self, obs_links, carry):
        z, new_carry = self.AttentionTorso_0(obs_links, carry)
        mu = self.Dense_0(z)[..., 0]  # [B, L] per-link delta mean
        return mu, self.log_std.expand_as(mu), new_carry


class AttentionValue(nn.Module):
    def __init__(self, num_links: int, features: int, hidden_dim: int = 64,
                 num_heads: int = 2):
        super().__init__()
        self.AttentionTorso_0 = AttentionTorso(features, hidden_dim, num_heads)
        self.Dense_0 = nn.Linear(hidden_dim, 1)

    def forward(self, obs_links, carry):
        z, new_carry = self.AttentionTorso_0(obs_links, carry)
        return self.Dense_0(z.mean(dim=1))[..., 0], new_carry


class LSTMPolicy(nn.Module):
    """Flat-observation LSTM policy (PPO_backup.py:25-78)."""

    def __init__(self, obs_dim: int, act_dim: int, hidden_dim: int = 64):
        super().__init__()
        self.Dense_0 = nn.Linear(obs_dim, hidden_dim)
        self.OptimizedLSTMCell_0 = OptimizedLSTMCell(hidden_dim, hidden_dim)
        self.Dense_1 = nn.Linear(hidden_dim, act_dim)
        self.log_std = _log_std(act_dim)

    def forward(self, obs, carry):
        x = torch.tanh(self.Dense_0(obs))
        carry, h = self.OptimizedLSTMCell_0(carry, x)
        mu = self.Dense_1(h)
        return mu, self.log_std.expand_as(mu), carry

    @staticmethod
    def initial_carry(batch: int, hidden_dim: int = 64, device=None) -> Carry:
        return zero_carry((batch,), hidden_dim, device)


class LSTMValue(nn.Module):
    def __init__(self, obs_dim: int, hidden_dim: int = 64):
        super().__init__()
        self.Dense_0 = nn.Linear(obs_dim, hidden_dim)
        self.OptimizedLSTMCell_0 = OptimizedLSTMCell(hidden_dim, hidden_dim)
        self.Dense_1 = nn.Linear(hidden_dim, 1)

    def forward(self, obs, carry):
        x = torch.tanh(self.Dense_0(obs))
        carry, h = self.OptimizedLSTMCell_0(carry, x)
        return self.Dense_1(h)[..., 0], carry


def _conv_same(x: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
    """flax ``Conv(kernel 3, padding="SAME")`` on a channels-last window
    ``x [B, K, C_in]`` with ``conv``'s weight ``[C_out, C_in, 3]``, as one
    float32 contraction over (tap, channel): cuDNN would convolve in TF32
    on the card."""
    K = x.shape[1]
    padded = F.pad(x, (0, 0, 1, 1))
    taps = torch.stack([padded[:, j:j + K] for j in range(3)], dim=-1)  # [B, K, C_in, 3]
    return torch.einsum("bkit,oit->bko", taps, conv.weight) + conv.bias


class StackedEncoder(nn.Module):
    """1-D conv over a frame-stacked window ``[B, K, obs_dim]``
    (SAC_copy.py:62-76): channels-last with "SAME" padding as flax, so the
    ``[B, K, 32]`` output flattens time-major as flax's does."""

    def __init__(self, obs_dim: int, stack_size: int, hidden_dim: int = 64):
        super().__init__()
        self.Conv_0 = nn.Conv1d(obs_dim, 32, 3, padding=1)
        self.Conv_1 = nn.Conv1d(32, 32, 3, padding=1)
        self.Dense_0 = nn.Linear(stack_size * 32, hidden_dim)

    def forward(self, obs_stack):
        x = F.relu(_conv_same(obs_stack, self.Conv_0))
        x = F.relu(_conv_same(x, self.Conv_1))
        return F.relu(self.Dense_0(x.reshape(x.shape[0], -1)))


class StackedPolicy(nn.Module):
    def __init__(self, obs_dim: int, act_dim: int, stack_size: int, hidden_dim: int = 64):
        super().__init__()
        self.StackedEncoder_0 = StackedEncoder(obs_dim, stack_size, hidden_dim)
        self.Dense_0 = nn.Linear(hidden_dim, act_dim)
        self.log_std = _log_std(act_dim)

    def forward(self, obs_stack, carry=None):
        mu = self.Dense_0(self.StackedEncoder_0(obs_stack))
        return mu, self.log_std.expand_as(mu), carry


class StackedValue(nn.Module):
    def __init__(self, obs_dim: int, stack_size: int, hidden_dim: int = 64):
        super().__init__()
        self.StackedEncoder_0 = StackedEncoder(obs_dim, stack_size, hidden_dim)
        self.Dense_0 = nn.Linear(hidden_dim, 1)

    def forward(self, obs_stack, carry=None):
        return self.Dense_0(self.StackedEncoder_0(obs_stack))[..., 0], carry


def _mlp(obs_dim: int, hidden: Sequence[int]) -> list:
    dims = [obs_dim, *hidden]
    return [nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:])]


class MLPPolicy(nn.Module):
    def __init__(self, obs_dim: int, act_dim: int, hidden: Sequence[int] = (64, 64)):
        super().__init__()
        layers = _mlp(obs_dim, hidden) + [nn.Linear(hidden[-1], act_dim)]
        for i, layer in enumerate(layers):
            self.add_module(f"Dense_{i}", layer)
        self.n_hidden = len(hidden)
        self.log_std = _log_std(act_dim)

    def forward(self, obs, carry=None):
        x = obs
        for i in range(self.n_hidden):
            x = torch.tanh(getattr(self, f"Dense_{i}")(x))
        mu = getattr(self, f"Dense_{self.n_hidden}")(x)
        return mu, self.log_std.expand_as(mu), carry


class MLPValue(nn.Module):
    def __init__(self, obs_dim: int, hidden: Sequence[int] = (64, 64)):
        super().__init__()
        layers = _mlp(obs_dim, hidden) + [nn.Linear(hidden[-1], 1)]
        for i, layer in enumerate(layers):
            self.add_module(f"Dense_{i}", layer)
        self.n_hidden = len(hidden)

    def forward(self, obs, carry=None):
        x = obs
        for i in range(self.n_hidden):
            x = torch.tanh(getattr(self, f"Dense_{i}")(x))
        return getattr(self, f"Dense_{self.n_hidden}")(x)[..., 0], carry


class UDLSTMTorso(nn.Module):
    """Per-link shared LSTM + upstream/downstream sum-minus-self
    aggregation (PPO_backup.py:419-596)."""

    def __init__(self, features: int, hidden_dim: int = 64):
        super().__init__()
        self.OptimizedLSTMCell_0 = OptimizedLSTMCell(features, hidden_dim)
        self.Dense_0 = nn.Linear(hidden_dim, hidden_dim)
        self.Dense_1 = nn.Linear(2 * hidden_dim, hidden_dim)

    def forward(self, obs_links, carry):  # [B, L, F]
        new_carry, h = self.OptimizedLSTMCell_0(carry, obs_links)
        link_f = self.Dense_0(h)  # [B, L, H]
        others = link_f.sum(dim=1, keepdim=True) - link_f  # sum of OTHER links
        return self.Dense_1(torch.cat([link_f, others], dim=-1)), new_carry

    @staticmethod
    def initial_carry(batch: int, num_links: int, hidden_dim: int = 64, device=None) -> Carry:
        return zero_carry((batch, num_links), hidden_dim, device)


class UDLSTMPolicy(nn.Module):
    """UD-LSTM actor (PPO_backup.py:419-521): shared latent layer over the
    flattened link features, per-link mean heads and a state-dependent
    softplus std."""

    def __init__(self, num_links: int, features: int, hidden_dim: int = 64,
                 min_std: float = 1e-3, max_std: float = 10.0):
        super().__init__()
        self.num_links, self.hidden_dim = num_links, hidden_dim
        self.min_std, self.max_std = min_std, max_std
        self.UDLSTMTorso_0 = UDLSTMTorso(features, hidden_dim)
        self.Dense_0 = nn.Linear(num_links * hidden_dim, num_links * hidden_dim)
        self.Dense_1 = nn.Linear(hidden_dim, 1)
        self.Dense_2 = nn.Linear(hidden_dim, 1)

    def forward(self, obs_links, carry):
        ud, new_carry = self.UDLSTMTorso_0(obs_links, carry)
        B = ud.shape[0]
        shared = self.Dense_0(ud.reshape(B, -1))
        z = F.relu(shared.reshape(B, self.num_links, self.hidden_dim))
        mu = self.Dense_1(z)[..., 0]  # [B, L]
        std = torch.clamp(F.softplus(self.Dense_2(z)[..., 0]), self.min_std, self.max_std)
        return mu, torch.log(std), new_carry


class UDLSTMValue(nn.Module):
    """UD-LSTM critic (PPO_backup.py:523-596)."""

    def __init__(self, num_links: int, features: int, hidden_dim: int = 64):
        super().__init__()
        self.UDLSTMTorso_0 = UDLSTMTorso(features, hidden_dim)
        self.Dense_0 = nn.Linear(hidden_dim, 1)

    def forward(self, obs_links, carry):
        ud, new_carry = self.UDLSTMTorso_0(obs_links, carry)
        return self.Dense_0(F.elu(ud.mean(dim=1)))[..., 0], new_carry


class GATLayer(nn.Module):
    """Dense graph-attention layer (PPO_backup.py:126-353): pairwise
    scores over link nodes, masked by ``adj`` where given."""

    def __init__(self, features: int, hidden_dim: int = 64):
        super().__init__()
        self.Dense_0 = nn.Linear(features, hidden_dim, bias=False)
        self.Dense_1 = nn.Linear(hidden_dim, 1, bias=False)
        self.Dense_2 = nn.Linear(hidden_dim, 1, bias=False)

    def forward(self, h, adj: Optional[torch.Tensor] = None):  # h: [B, L, F]
        wh = self.Dense_0(h)
        a_src = self.Dense_1(wh)[..., 0]  # [B, L]
        a_dst = self.Dense_2(wh)[..., 0]
        scores = F.leaky_relu(a_src[:, :, None] + a_dst[:, None, :], 0.2)  # [B, L, L]
        if adj is not None:
            scores = torch.where(adj > 0, scores, torch.full_like(scores, -1e9))
        return torch.tanh(torch.softmax(scores, dim=-1) @ wh)


class GATLSTMPolicy(nn.Module):
    """Per-link shared LSTM -> GAT spatial attention -> per-link heads."""

    def __init__(self, num_links: int, features: int, hidden_dim: int = 64):
        super().__init__()
        self.Dense_0 = nn.Linear(features, hidden_dim)
        self.OptimizedLSTMCell_0 = OptimizedLSTMCell(hidden_dim, hidden_dim)
        self.GATLayer_0 = GATLayer(hidden_dim, hidden_dim)
        self.Dense_1 = nn.Linear(hidden_dim, 1)
        self.log_std = _log_std(num_links)

    def forward(self, obs_links, carry, adj: Optional[torch.Tensor] = None):
        x = torch.tanh(self.Dense_0(obs_links))
        new_carry, h = self.OptimizedLSTMCell_0(carry, x)
        mu = self.Dense_1(self.GATLayer_0(h, adj))[..., 0]
        return mu, self.log_std.expand_as(mu), new_carry


class GATLSTMValue(nn.Module):
    def __init__(self, num_links: int, features: int, hidden_dim: int = 64):
        super().__init__()
        self.Dense_0 = nn.Linear(features, hidden_dim)
        self.OptimizedLSTMCell_0 = OptimizedLSTMCell(hidden_dim, hidden_dim)
        self.GATLayer_0 = GATLayer(hidden_dim, hidden_dim)
        self.Dense_1 = nn.Linear(hidden_dim, 1)

    def forward(self, obs_links, carry, adj: Optional[torch.Tensor] = None):
        x = torch.tanh(self.Dense_0(obs_links))
        new_carry, h = self.OptimizedLSTMCell_0(carry, x)
        z = self.GATLayer_0(h, adj)
        return self.Dense_1(z.mean(dim=1))[..., 0], new_carry


# -- SAC networks (SAC_copy.py:313-420) --------------------------------------


class SACActor(nn.Module):
    """Tanh-squashed Gaussian actor over a frame-stacked window."""

    def __init__(self, obs_dim: int, act_dim: int, stack_size: int, hidden_dim: int = 64,
                 log_std_min: float = -20.0, log_std_max: float = 2.0):
        super().__init__()
        self.log_std_min, self.log_std_max = log_std_min, log_std_max
        self.StackedEncoder_0 = StackedEncoder(obs_dim, stack_size, hidden_dim)
        self.Dense_0 = nn.Linear(hidden_dim, hidden_dim)
        self.Dense_1 = nn.Linear(hidden_dim, act_dim)
        self.Dense_2 = nn.Linear(hidden_dim, act_dim)

    def forward(self, obs_stack):
        h = F.relu(self.Dense_0(self.StackedEncoder_0(obs_stack)))
        log_std = torch.clamp(self.Dense_2(h), self.log_std_min, self.log_std_max)
        return self.Dense_1(h), log_std

    def sample(self, obs_stack, gen: Optional[torch.Generator] = None,
               eps: Optional[torch.Tensor] = None):
        """A reparameterised tanh-Gaussian action ``[B, A]`` and its log
        probability ``[B]``; ``eps`` (standard normal, ``[B, A]``) is drawn
        from ``gen`` unless given."""
        mu, log_std = self(obs_stack)
        if eps is None:
            eps = torch.randn(mu.shape, generator=gen, device=mu.device, dtype=mu.dtype)
        a = torch.tanh(mu + torch.exp(log_std) * eps)
        # log prob with the tanh correction
        logp = (-0.5 * eps ** 2 - log_std - 0.5 * math.log(2 * math.pi)).sum(-1)
        logp = logp - torch.log(1 - a ** 2 + 1e-6).sum(-1)
        return a, logp


class SACCritic(nn.Module):
    """Twin Q networks.  flax names the Dense layers in construction order:
    ``Dense_0`` is q1's head and ``Dense_1`` its hidden layer
    (``nn.Dense(1)(relu(nn.Dense(h)(x)))``), ``Dense_2``/``Dense_3`` the
    same for q2."""

    def __init__(self, obs_dim: int, act_dim: int, stack_size: int, hidden_dim: int = 64):
        super().__init__()
        self.StackedEncoder_0 = StackedEncoder(obs_dim, stack_size, hidden_dim)
        self.Dense_0 = nn.Linear(hidden_dim, 1)
        self.Dense_1 = nn.Linear(hidden_dim + act_dim, hidden_dim)
        self.Dense_2 = nn.Linear(hidden_dim, 1)
        self.Dense_3 = nn.Linear(hidden_dim + act_dim, hidden_dim)

    def forward(self, obs_stack, action):
        x = torch.cat([self.StackedEncoder_0(obs_stack), action], dim=-1)
        q1 = self.Dense_0(F.relu(self.Dense_1(x)))[..., 0]
        q2 = self.Dense_2(F.relu(self.Dense_3(x)))[..., 0]
        return q1, q2


# -- the PPO families ----------------------------------------------------------

PER_LINK = ("attention", "gat", "udlstm")  # families over [L, features] observations


def build_family(net_type: str, obs_dim: int, act_dim: int,
                 features_per_link: Optional[int] = None, hidden_dim: int = 64,
                 stack_size: int = 1):
    """The ``(policy, value)`` modules of a PPO family, as the JAX
    ``PPOAgent._build_networks`` makes them (per-link families over
    ``obs_dim // features_per_link`` links)."""
    if net_type in PER_LINK:
        if not features_per_link:
            raise ValueError(f"{net_type} nets need features_per_link")
        L = obs_dim // features_per_link
        policy, value = {"attention": (AttentionPolicy, AttentionValue),
                         "gat": (GATLSTMPolicy, GATLSTMValue),
                         "udlstm": (UDLSTMPolicy, UDLSTMValue)}[net_type]
        return (policy(L, features_per_link, hidden_dim),
                value(L, features_per_link, hidden_dim))
    if net_type == "lstm":
        return LSTMPolicy(obs_dim, act_dim, hidden_dim), LSTMValue(obs_dim, hidden_dim)
    if net_type == "stacked":
        return (StackedPolicy(obs_dim, act_dim, stack_size, hidden_dim),
                StackedValue(obs_dim, stack_size, hidden_dim))
    if net_type == "mlp":
        return MLPPolicy(obs_dim, act_dim), MLPValue(obs_dim)
    raise ValueError(f"unknown net_type {net_type}")


def family_carry(net_type: str, batch: int, num_links: Optional[int] = None,
                 hidden_dim: int = 64, device=None):
    """The initial carry of a family for ``batch`` replicas: zeros
    ``(c, h)`` for the recurrent ones, ``()`` for stacked and mlp."""
    if net_type in PER_LINK:
        return zero_carry((batch, num_links), hidden_dim, device)
    if net_type == "lstm":
        return zero_carry((batch,), hidden_dim, device)
    return ()


# -- flax's initializers ------------------------------------------------------


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen) -> None:
    """flax ``lecun_normal``: a normal truncated at two standard
    deviations, scaled so the variance is ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)


@torch.no_grad()
def init_flax_(module: nn.Module, gen: Optional[torch.Generator] = None) -> nn.Module:
    """Draw ``module``'s weights with flax's default initializers: LeCun
    normal kernels (fan-in over the input axes), orthogonal LSTM
    recurrent kernels per gate, zero biases, unit LayerNorm scales;
    ``log_std`` keeps its constant -0.5."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            _lecun_normal_(m.weight, m.in_features, gen)
        elif isinstance(m, nn.Conv1d):
            _lecun_normal_(m.weight, m.in_channels * m.kernel_size[0], gen)
        elif isinstance(m, DenseGeneral):
            _lecun_normal_(m.kernel, math.prod(m.kernel.shape[:m.n_in]), gen)
        elif isinstance(m, OptimizedLSTMCell):
            for gate in range(4):
                rows = slice(gate * m.hidden, (gate + 1) * m.hidden)
                _lecun_normal_(m.weight_ih[rows], m.weight_ih.shape[1], gen)
                nn.init.orthogonal_(m.weight_hh[rows], generator=gen)
            m.bias_hh.zero_()
        else:
            continue
        if getattr(m, "bias", None) is not None:
            m.bias.zero_()
    return module
