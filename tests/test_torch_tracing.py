"""The port's spans (``pednstream_tpu_torch.tracing``) on the CPU: no
profiler record while no profiler runs; under a CPU profiler one engine
step shows each phase span once, inside ``engine.step``, with every ATen
operation of the step inside exactly one phase; an env RL step shows its
parts; the scenario build's kept spans nest, share the profiler's clock
and do not grow with steps."""

import pytest
import torch

from pednstream_tpu_torch import engine, tracing
from pednstream_tpu_torch.env.agents import build_agent_spec, build_spaces
from pednstream_tpu_torch.env.core import PedNetEnvCore
from pednstream_tpu_torch.generator import NetworkEnvGenerator
from pednstream_tpu_torch.scenario import build_scenario

torch.set_num_threads(1)

DATASET = "nine_intersections"  # 24 links, routed, three agents
PHASES = ("engine.history", "engine.sending", "engine.routing", "engine.receiving",
          "engine.node_solve", "engine.link_update")


def build(**kwargs):
    args = NetworkEnvGenerator(device="cpu").scenario_args(DATASET)
    args["params"]["seed"] = 3
    return build_scenario(**args, device="cpu", **kwargs)


@pytest.fixture(scope="module")
def scn():
    return build(binomial_mode="fast")


def actions(core, batch: int) -> dict:
    """Every agent's largest action, for each of ``batch`` replicas."""
    spaces, _ = build_spaces(core.spec, core.obs_mode)
    return {a: torch.as_tensor(sp.high).expand((batch,) + sp.high.shape).clone()
            for a, sp in spaces.items()}


def profiled(fn):
    """``fn()`` under a CPU profiler; its host events as ``(name, start,
    end)`` on the profiler's clock."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()]


def inside(a, b):
    """Whether event ``a`` lies within event ``b``."""
    return b[1] <= a[1] and a[2] <= b[2]


def test_no_profiler_no_record(scn, monkeypatch):
    """With no profiler, spans and kept spans enter no profiler record: a
    record that raises is never reached by a build, engine steps and an
    env RL step."""
    def refuse(name):
        raise AssertionError(f"a profiler record was opened for {name}")

    monkeypatch.setattr(tracing, "_RecordFunctionFast", refuse)
    assert tracing.span("engine.step") is tracing.span("env.step")
    small = build()
    gen = torch.Generator().manual_seed(0)
    st = engine.simulate_batched(scn, scn.engine_params, scn.init_state(2), 3, gen=gen,
                                 stochastic=True)
    assert st.t == 1 + 3
    core = PedNetEnvCore(small, build_agent_spec(small))
    core.batch_step(core.batch_reset(2)[0], actions(core, 2), gen)


def test_engine_step_phases(scn):
    """One routed step under a CPU profiler: each engine span once, every
    phase inside ``engine.step``, every ATen operation inside exactly one
    phase."""
    gen = torch.Generator().manual_seed(1)
    box = {"st": engine.simulate_batched(scn, scn.engine_params, scn.init_state(2), 2,
                                         gen=gen, stochastic=True)}
    assert scn.routing is not None

    def one_step():
        box["st"], _ = engine.step_fn(scn, scn.engine_params, box["st"], gen, True, False)

    events = profiled(one_step)
    spans = {name: [e for e in events if e[0] == name] for name in ("engine.step",) + PHASES}
    assert all(len(v) == 1 for v in spans.values()), {k: len(v) for k, v in spans.items()}
    step = spans["engine.step"][0]
    phases = [spans[p][0] for p in PHASES]
    assert all(inside(p, step) for p in phases)
    assert all(a[2] <= b[1] for a, b in zip(phases, phases[1:]))  # in order, apart
    aten = [e for e in events if e[0].startswith("aten::")]
    assert len(aten) > 50
    for op in aten:
        assert sum(inside(op, p) for p in phases) == 1, op


def test_env_step_parts(scn):
    """An RL step of ``action_gap`` 3 shows ``env.step`` around one
    ``env.actions``, three ``env.rewards`` (each after an engine step),
    one ``env.observations`` and three ``engine.step``s."""
    core = PedNetEnvCore(scn, build_agent_spec(scn), action_gap=3)
    states, _ = core.batch_reset(2)
    gen = torch.Generator().manual_seed(2)
    acts = actions(core, 2)
    events = profiled(lambda: core.batch_step_randomized(states, acts, None, gen))
    named = {n: [e for e in events if e[0] == n]
             for n in ("env.step", "env.actions", "env.rewards", "env.observations",
                       "engine.step")}
    assert {n: len(v) for n, v in named.items()} == {
        "env.step": 1, "env.actions": 1, "env.rewards": 3, "env.observations": 1,
        "engine.step": 3}
    step = named["env.step"][0]
    assert all(inside(e, step) for v in named.values() for e in v)
    for eng, rew in zip(named["engine.step"], named["env.rewards"]):
        assert eng[2] <= rew[1]
    assert named["env.actions"][0][2] <= named["engine.step"][0][1]
    assert named["engine.step"][-1][2] <= named["env.observations"][0][1]


def test_kept_spans_of_a_build(scn):
    """The build keeps ``scenario.build`` with ``scenario.od_paths`` inside
    it; under a profiler the kept start is within 1 ms of its trace event
    (one clock); steps add no kept span."""
    before = len(tracing.kept_spans())
    box = {}
    events = profiled(lambda: box.update(scn=build()))
    kept = tracing.kept_spans()[before:]
    assert [k[:2] for k in kept] == [("scenario.od_paths", "scenario.build"),
                                     ("scenario.build", None)]
    (paths, _, p0, p1), (_, _, b0, b1) = kept
    assert b0 <= p0 <= p1 <= b1
    for name, start in (("scenario.od_paths", p0), ("scenario.build", b0)):
        (ev,) = [e for e in events if e[0] == name]
        assert abs(ev[1] - start) < 1_000_000, (name, ev[1] - start)
    gen = torch.Generator().manual_seed(4)
    small = box["scn"]
    engine.simulate_batched(small, small.engine_params, small.init_state(2), 5, gen=gen,
                            stochastic=True)
    assert len(tracing.kept_spans()) == before + 2
