"""The port on the card: the CUDA kernel of fused_history_reads against its
plain version, and engine rollouts on cuda against the CPU.  Every test
here needs a GPU, skips without one, and is marked ``slow``, so the
default tiers leave it out.  The file imports no JAX (nor does it need
tests/conftest.py), so on a machine with a card it runs as

    python -m pytest --noconftest -p no:cacheprovider -m slow tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from pednstream_tpu_torch import NetworkEnvGenerator, build_scenario, simulate
from pednstream_tpu_torch.ops import fused_history_reads, fused_history_reads_ref

pytestmark = pytest.mark.slow


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def make_inputs(B, H, E, seed, device):
    rng = np.random.default_rng(seed)
    rings = [rng.uniform(0, 100, (B, H, E)).astype(np.float32) for _ in range(3)]
    idx = [rng.integers(-5, 3 * H, (B, E)).astype(np.int32) for _ in range(3)]
    coefs = rng.uniform(0, 1, (B, 4, E)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in rings + idx + [coefs]]


@pytest.mark.parametrize("B,H,E", [(1, 16, 1), (5, 17, 1000), (2, 64, 4097), (1024, 16, 938)])
def test_kernel_equals_plain_bitwise(cuda, B, H, E):
    args = make_inputs(B, H, E, seed=B + H + E, device=cuda)
    before = fused_history_reads.launches
    got = fused_history_reads(*args, H)
    want = fused_history_reads_ref(*args, H)
    torch.cuda.synchronize()
    assert fused_history_reads.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_kernel_unbatched_call(cuda):
    args = make_inputs(1, 24, 300, seed=1, device=cuda)
    single = fused_history_reads(*(a[0] for a in args), 24)
    batched = fused_history_reads(*args, 24)
    for a, b in zip(single, batched):
        assert torch.equal(a, b[0])


def test_kernel_rejects_mixed_devices(cuda):
    args = make_inputs(2, 16, 10, seed=2, device=cuda)
    args[3] = args[3].cpu()
    with pytest.raises(ValueError):
        fused_history_reads(*args, 16)


def test_rollout_on_cuda_matches_cpu(cuda):
    """Deterministic butterfly_scC, H=64, 120 steps: the card (kernel)
    against the CPU (plain version), at the 5e-3 density atol the CPU
    tests hold the port to against JAX."""
    args = NetworkEnvGenerator().scenario_args("butterfly_scC")
    args["params"]["seed"] = 3
    density = {}
    for device in ("cuda", "cpu"):
        scn = build_scenario(**args, history_window=64, device=device)
        before = fused_history_reads.launches
        final, _ = simulate(scn, scn.engine_params, scn.init_state(2), 120, record=False)
        assert fused_history_reads.launches - before == (120 if device == "cuda" else 0)
        density[device] = final.density.cpu()
    torch.testing.assert_close(density["cuda"], density["cpu"], rtol=0, atol=5e-3)


def test_stochastic_rollout_on_cuda(cuda):
    """melbourne, 64 replicas, H=16, 100 stochastic steps on the card:
    finite, non-negative, mass conserved to float32 rounding."""
    scn = NetworkEnvGenerator(history_window=16, device=cuda).create_network("melbourne")
    gen = torch.Generator(device=cuda).manual_seed(0)
    final, _ = simulate(scn, scn.engine_params, scn.init_state(64), 100, gen=gen,
                        stochastic=True, record=False)
    for name, x in vars(final).items():
        if isinstance(x, torch.Tensor):
            assert x.device.type == "cuda", name
            assert bool(torch.isfinite(x).all()) and not bool((x < 0).any()), name
    peak = final.cum_in.abs().max().item()
    err = (final.cum_in - final.cum_out - final.num_peds).abs().max().item()
    assert err <= 100 * 1.5 * 2.0 ** -23 * max(peak, 1.0)
