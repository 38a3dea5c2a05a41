"""The comparison that decides ``correct``.

During the window the harness keeps, at a step of each episode drawn from
the seed, a sample of the replicas: their state before the step, the
engine generator's state, the actions (env), and, from the program's own
step, the state after it, the routed turning fractions and the binomial
samples it drew, and in the env the observations and rewards.  At each
episode's start it keeps the same replicas' initial state (and, in the
env, their randomized parameters).  Once the window has closed, the plain
reference (``portbench.reference``: its own scenario build from the raw
files, its own randomization, the same generator streams) works out each
of those from the program's state before the step, and this module
compares the two element by element.

The elements fall into groups, one per compared tensor (``step.speed``,
``step.rewards.<agent>``, ``step.obs.<agent>``, ``step.phi0``,
``start.eps.<leaf>``, ...), each judged on its own.  Two numbers come out:

- ``group_mismatch``: the largest share, over the groups, of a group's
  elements that lie farther from the reference than float32 rounding,
  ``|p - r| > 1e-6 (1 + |r|)`` (or a NaN on one side only);
- ``count_gap``: the largest ``|p - r|`` of the tensors that count persons
  (:data:`COUNTS`), in persons.

``detail`` keeps, per group, the elements, the mismatches, the largest
relative gap ``|p - r| / (1 + |r|)`` and the largest gap.

The reference follows the program step by step from the program's own
state; the start of each episode (initial state, randomized parameters)
is compared by itself.
"""

import dataclasses
from typing import Dict, List, Optional

import torch

REL_TOL = 1e-6
ALTERED_PERSONS = 1.0


def skew(x: torch.Tensor) -> torch.Tensor:
    """Every element moved by a thousandth of its size and a thousandth:
    a value computed wrongly everywhere, the planted faults' alteration."""
    return x * 1.001 + 1e-3
# the compared tensors that count whole persons (or flows of them), whose
# gap ``count_gap`` gives in persons
COUNTS = {"cum_in", "cum_out", "inflow", "outflow", "num_peds", "sending_prev", "recv_prev",
          "virt_dep", "virt_arr", "virt_dep_cum", "virt_arr_cum", "cum_in_ring",
          "cum_out_ring", "inflow_ring", "binom0", "binom1", "binom2"}


class RowDraws:
    """The engine's random draws for a sample of the replicas: each draw is
    made at the whole batch's shape from a generator in the program's
    generator state, and the sampled rows kept, so the reference's rows see
    the same numbers the program's did (``engine.draw``'s protocol)."""

    def __init__(self, gen_state, batch: int, rows: torch.Tensor, device, binom_in=()):
        self.gen = torch.Generator(device=device)
        self.gen.set_state(gen_state)
        self.batch, self.rows = batch, rows
        self.binom_in = list(binom_in)

    def draw(self, normal: bool, shape, dtype, device) -> torch.Tensor:
        fn = torch.randn if normal else torch.rand
        full = fn((self.batch,) + tuple(shape[1:]), generator=self.gen, dtype=dtype,
                  device=device)
        return full[self.rows]

    def binomial(self, nf: torch.Tensor, pc: torch.Tensor) -> torch.Tensor:
        """``torch.binomial`` over the whole batch: the rows it does not
        check hold the program's counts and probabilities of this call
        (only so that the stream's draws fall as they fell), the checked
        rows the reference's own."""
        n, p = self.binom_in.pop(0)
        n_full = torch.floor(torch.clamp(n, min=0.0))
        p_full = torch.clamp(p, 0.0, 1.0).to(n_full.dtype).expand_as(n_full).contiguous()
        n_full[self.rows], p_full[self.rows] = nf, pc
        return torch.binomial(n_full, p_full, generator=self.gen)[self.rows]


class Tally:
    """Element counts, mismatches and the largest gap, by group."""

    def __init__(self):
        self.groups: Dict[str, List[float]] = {}

    def add(self, group: str, got: torch.Tensor, want: torch.Tensor) -> None:
        got = got.detach().to(torch.float64)
        want = want.detach().to(torch.float64)
        if got.shape != want.shape:
            raise ValueError(f"{group}: shape {tuple(got.shape)} against {tuple(want.shape)}")
        diff = (got - want).abs()
        gap = diff / (1.0 + want.abs())
        both_nan = torch.isnan(got) & torch.isnan(want)
        one_nan = torch.isnan(got) != torch.isnan(want)
        gap = torch.where(one_nan, float("inf"), torch.where(both_nan, 0.0, gap))
        diff = torch.where(one_nan, float("inf"), torch.where(both_nan, 0.0, diff))
        n, bad = got.numel(), int((gap > REL_TOL).sum())
        g = self.groups.setdefault(group, [0, 0, 0.0, 0.0])
        g[0] += n
        g[1] += bad
        if n:
            g[2] = max(g[2], float(gap.max()))
            g[3] = max(g[3], float(diff.max()))

    def numbers(self) -> Dict[str, float]:
        shares = [g[1] / g[0] for g in self.groups.values() if g[0]]
        counts = [g[3] for k, g in self.groups.items() if k.split(".")[-1] in COUNTS]
        return {"group_mismatch": max(shares, default=0.0),
                "count_gap": max(counts, default=0.0)}

    def detail(self) -> Dict[str, list]:
        return {k: list(g) for k, g in sorted(self.groups.items())}


def _tensors(obj) -> Dict[str, torch.Tensor]:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)}


def to_reference_state(ref, program_state):
    """A copy of the program's state rows as the reference's state class (a
    step writes its rings in place, and a record may be checked again)."""
    return ref.state.NetworkState(**{
        f.name: getattr(program_state, f.name).clone()
        if isinstance(getattr(program_state, f.name), torch.Tensor)
        else getattr(program_state, f.name) for f in dataclasses.fields(program_state)})


def tally_state(tally: Tally, group: str, got, want) -> None:
    if got.t != want.t:
        tally.add(group + ".t", torch.tensor([float(got.t)]), torch.tensor([float(want.t)]))
    want_t = _tensors(want)
    for name, x in _tensors(got).items():
        tally.add(f"{group}.{name}", x, want_t[name])


def round_bf16(x):
    """A float tensor (or a dict of them, or a state) stored in bfloat16 and
    read back: the control's precision."""
    if isinstance(x, dict):
        return {k: round_bf16(v) for k, v in x.items()}
    if isinstance(x, list):
        return [round_bf16(v) for v in x]
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{k: round_bf16(v) for k, v in _tensors(x).items()})
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x.to(torch.bfloat16).to(x.dtype)
    return x


class StepReference:
    """The reference side of one cell: its scenario built from the raw
    files (:meth:`build`), then an episode's start and a step (one call of
    :meth:`step_once`) worked out for any record.  ``faults`` names the
    faults of :func:`plant` that the cell can have."""

    faults: tuple = ()

    def __init__(self, config: dict, traffic: dict, device):
        from portbench import reference as ref
        from portbench.reference import agents, envcore, generator, randomize  # noqa: F401
        from portbench.drivers import seed_demand

        self.ref, self.config, self.traffic = ref, config, traffic
        self.device = torch.device(device)
        self.batch = int(traffic["batch"])
        seed_demand(config)
        self.build(ref, config)

    def build(self, ref, config: dict) -> None:
        raise NotImplementedError

    def step_once(self, st, pre: dict, eps, draws) -> dict:
        """The reference's step from the state ``st``: ``{"state": ...}``
        and what else the step produces (``obs``, ``rewards``)."""
        raise NotImplementedError

    def engine_params(self, world_gen_state, rows):
        """The randomized parameters of the replicas ``rows`` (none where
        the worlds are not randomized)."""
        return None

    def start(self, tally: Tally, rec: dict, rows, control: bool = False) -> None:
        """Compares an episode's start with the reference's."""
        want = self.scn.init_state(len(rows))
        got = rec["state"]
        if control:
            got = round_bf16(want)
        tally_state(tally, "start", got, want)
        if "eps" in rec:
            want_eps = self.engine_params(rec["world_gen"], rows)
            got_eps = round_bf16(want_eps) if control else rec["eps"]
            want_t = _tensors(want_eps)
            for name, x in _tensors(got_eps).items():
                tally.add("start.eps." + name, x, want_t[name])

    def step(self, pre: dict, rows, eps=None, state=None, binom_in=()) -> dict:
        """The reference's step from the state ``state`` (the program's
        rows before the step, unless given); ``binom_in`` as
        :meth:`RowDraws.binomial` takes it."""
        st = to_reference_state(self.ref, pre["state"] if state is None else state)
        draws = RowDraws(pre["gen"], self.batch, rows, self.device, binom_in)
        got: Dict[str, list] = {}
        from portbench.drivers import capture

        with capture(self.ref.engine, None, got):
            out = self.step_once(st, pre, eps, draws)
        return {**out, **got}

    def compare_step(self, tally: Tally, pre: dict, post: dict, rows, eps=None,
                     control: bool = False) -> None:
        """Compares the program's step (``post``) with the reference's; with
        ``control`` the reference in bfloat16 storage stands in the
        program's place."""
        binom_in = post.get("binom_in", ())
        want = self.step(pre, rows, eps, binom_in=binom_in)
        if control:
            post = round_bf16(self.step(pre, rows, round_bf16(eps),
                                        state=round_bf16(pre["state"]), binom_in=binom_in))
        tally_state(tally, "step", post["state"], want["state"])
        for key in ("phi", "binom"):
            if len(post.get(key, [])) != len(want.get(key, [])):
                tally.add(f"step.{key}.calls", torch.tensor([float(len(post.get(key, [])))]),
                          torch.tensor([float(len(want.get(key, [])))]))
            for i, (a, b) in enumerate(zip(post.get(key, []), want.get(key, []))):
                tally.add(f"step.{key}{i}", a, b)
        for key in ("obs", "rewards"):
            if set(post.get(key, {})) != set(want.get(key, {})):
                tally.add(f"step.{key}.agents", torch.tensor([1.0]), torch.tensor([0.0]))
            for agent, x in post.get(key, {}).items():
                if agent in want[key]:
                    tally.add(f"step.{key}.{agent}", x, want[key][agent])


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, list]:
    """``{name: [number, limit]}`` for every limit; a number is within its
    limit when it is not above it."""
    return {name: [numbers[name], limit] for name, limit in limits.items()}


def run_checks(reference: StepReference, records: List[dict], control: bool = False,
               fault: Optional[str] = None) -> Tally:
    """Every record of the window compared; ``fault`` plants one of the
    faults of :func:`plant` in the program's outputs first."""
    tally = Tally()
    eps_rows = {}
    for rec in records:
        rows = rec["rows"]
        if rec["kind"] == "start":
            reference.start(tally, rec, rows, control)
            if "eps" in rec:
                eps_rows[rec["episode"]] = reference.engine_params(rec["world_gen"], rows)
            continue
        post = rec["post"] if fault is None else plant(fault, rec, reference)
        reference.compare_step(tally, rec["pre"], post, rows, eps_rows.get(rec["episode"]),
                               control)
    return tally


def plant(fault: str, rec: dict, reference: StepReference) -> dict:
    """The program's step outputs with a fault planted where they are
    produced: ``"unchanged"`` (the step returns its state as it was),
    ``"half_batch"`` (the second half of the batch left unstepped),
    ``"altered"`` (one link's inflow off by ``ALTERED_PERSONS`` in every
    replica), ``"speed"`` (every link's speed computed wrongly, by
    :func:`skew`), ``"reward"`` and ``"obs"`` (every reward, or every
    observation, computed wrongly)."""
    post = dict(rec["post"])
    pre_state = rec["pre"]["state"]
    st = post["state"]
    if fault == "unchanged":
        post["state"] = pre_state.replace(t=st.t)
    elif fault == "half_batch":
        second = rec["rows"] >= reference.batch // 2
        post["state"] = st.replace(**{
            k: torch.where(second.view(-1, *([1] * (v.dim() - 1))), getattr(pre_state, k), v)
            for k, v in _tensors(st).items()})
    elif fault == "altered":
        link = st.inflow.shape[1] // 2
        inflow = st.inflow.clone()
        inflow[:, link] += ALTERED_PERSONS
        post["state"] = st.replace(inflow=inflow)
    elif fault == "speed":
        post["state"] = st.replace(speed=skew(st.speed))
    elif fault in ("reward", "obs"):
        key = {"reward": "rewards", "obs": "obs"}[fault]
        post[key] = {a: skew(x) for a, x in post[key].items()}
    else:
        raise ValueError(f"unknown fault {fault!r}")
    return post
