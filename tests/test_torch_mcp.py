"""The port's service layer (pednstream_tpu_torch.mcp) on the CPU: the
JAX package's own MCP tests re-run on the port, the pure-Python config
tools held exactly to the JAX server's replies, a deterministic served run
against the JAX server's, and the properties a threaded server over
in-place state must keep (recorded steps that stay put, JSON replies,
resumable chunks, cancel, the busy reply, simulations stepped from two
threads, no fallback from the card to the CPU)."""

import copy
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from pednstream_tpu.mcp import server as jax_server
from pednstream_tpu_torch import make_step
from pednstream_tpu_torch.mcp import server
from pednstream_tpu_torch.mcp.run_mcp import run_workflow

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
# butterfly_scC ships unseeded (fresh demand per build): every comparison
# of two simulations seeds it
SEEDED = {"params": {"seed": 3}}
ATOL_ROLLOUT = 5e-3  # the port's rollout tolerance against JAX (density)


@pytest.fixture(autouse=True)
def outputs_under_tmp(tmp_path, monkeypatch):
    """Nothing is written into the checkout."""
    monkeypatch.setattr(server._manager, "base_output_dir", tmp_path / "outputs")
    monkeypatch.setattr(jax_server._manager, "base_output_dir", tmp_path / "jax_outputs")


@pytest.fixture
def seeded_data(tmp_path):
    """A dataset directory holding butterfly_scC with ``seed: 3`` in its
    YAML: the JAX server's generator reloads the file when it builds, so
    only a seed in the file reaches both packages' scenarios."""
    import shutil

    d = tmp_path / "data" / "butterfly_scC"
    shutil.copytree(ROOT / "data" / "butterfly_scC", d)
    cfg = yaml.safe_load((d / "sim_params.yaml").read_text())
    cfg["simulation"]["seed"] = SEEDED["params"]["seed"]
    (d / "sim_params.yaml").write_text(yaml.safe_dump(cfg, sort_keys=False))
    return str(tmp_path / "data")


def create(name="butterfly_scC", overrides=SEEDED, **kw):
    r = server.create_environment(name, overrides=copy.deepcopy(overrides), device="cpu", **kw)
    assert r["status"] == "CREATED", r
    return r["sim_id"], server._manager.get(r["sim_id"])


def states_equal(a, b):
    assert a.t == b.t
    for name, x in vars(a).items():
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, getattr(b, name)), name


# -- the JAX package's MCP tests, on the port ---------------------------------


def test_mcp_workflow_roundtrip(tmp_path):
    log = run_workflow(steps=20, data_dir=str(tmp_path), verbose=False, device="cpu")
    # config authoring happened and produced a loadable nested config
    assert log["upsert_config"][0]["saved"]
    assert log["read_config"][0]["config"]["simulation"]["simulation_steps"] >= 30
    # resumable stepping hit both chunks
    assert [s["current_step"] for s in log["get_status"]] == [10, 20]
    # the cached step survives across run_simulation calls
    sim_id = log["create_environment"][0]["sim_id"]
    assert server._manager.get(sim_id).step_fn is not None
    # outputs + snapshot written
    assert log["save_outputs"][0]["output_dir"]
    assert log["visualize_snapshot"][0]["image_path"].endswith(".png")
    assert os.path.exists(log["visualize_snapshot"][0]["image_path"])
    # every reply is JSON as it stands: no tensor or numpy scalar that
    # the HTTP transport's default=str would quietly turn into a string
    for tool, replies in log.items():
        for reply in replies:
            assert json.loads(json.dumps(reply)) == reply, tool
    env = log["create_environment"][0]
    assert all(type(env[k]) is int for k in ("num_nodes", "num_links", "simulation_steps"))


FLAT = {
    "params": {
        "simulation_steps": 100, "unit_time": 10,
        "path_finder": {"k_paths": 2},
        "default_link": {"length": 50, "width": 3, "free_flow_speed": 1.1,
                         "k_critical": 2, "k_jam": 6},
        "links": {"0_1": {"width": 5}},
    },
    "origin_nodes": [0],
    "destination_nodes": [2],
    "adjacency_matrix": [[0, 1], [1, 0]],
    "od_flows": {"0_2": 5},
}
NESTED = {
    "network": {"origin_nodes": [1], "adjacency_matrix": [[0, 1], [1, 0]]},
    "simulation": {"simulation_steps": 50, "unit_time": 10},
    "default_link": {"length": 50, "width": 3, "free_flow_speed": 1.1,
                     "k_critical": 2, "k_jam": 6},
}
BAD = {
    "network": {"origin_nodes": [0], "adjacency_matrix": [[0, 1], [1, 0]]},
    "simulation": {"simulation_steps": -5, "unit_time": 10},
    "default_link": {"length": 50, "width": -3, "free_flow_speed": 1.1,
                     "k_critical": 6, "k_jam": 2},
    "links": {"banana": {"width": 1}},
    "od_flows": {"0_1": -4},
}


def test_normalize_config_legacy_keys():
    norm = server.normalize_config(FLAT)
    assert norm["simulation"]["simulation_steps"] == 100
    assert norm["simulation"]["path_finder"] == {"k_paths": 2}
    assert norm["network"]["origin_nodes"] == [0]
    assert norm["network"]["adjacency_matrix"] == [[0, 1], [1, 0]]
    assert norm["default_link"]["k_jam"] == 6
    assert norm["links"] == {"0_1": {"width": 5}}
    assert norm["od_flows"] == {"0_2": 5}

    norm2 = server.normalize_config(NESTED)
    assert norm2["network"]["origin_nodes"] == [1]
    assert norm2["simulation"]["unit_time"] == 10

    v = server.validate_config(config=FLAT)
    assert v["valid"], v["errors"]
    assert "simulation" in v["normalized"]


def test_validate_config_rejects_bad_values():
    v = server.validate_config(config=BAD)
    assert not v["valid"]
    paths = {e["path"] for e in v["errors"]}
    assert {"default_link.width", "default_link.k_jam", "links.banana", "od_flows.0_1",
            "simulation.simulation_steps"} <= paths


def test_agent_client_tool_schemas():
    from pednstream_tpu_torch.mcp.agent_client import TOOL_SPECS

    specs = {s["name"]: s for s in TOOL_SPECS}
    assert set(specs) == set(server.TOOLS)
    assert "sim_id" in specs["run_simulation"]["parameters"]["properties"]
    assert specs["run_simulation"]["parameters"]["required"] == ["sim_id"]
    assert (specs["create_environment"]["parameters"]["properties"]
            ["config_name"]["type"] == "string")
    assert (specs["run_simulation"]["parameters"]["properties"]
            ["steps"]["type"] == "integer")
    for name in ("create_environment", "visualize_snapshot", "upsert_config"):
        assert specs[name]["parameters"]["properties"], name
        assert specs[name]["description"]


def test_http_transport_smoke():
    """Live-socket HTTP smoke test: tool listing with schemas, create ->
    run -> status over POST, resource read over GET, the error codes."""
    import urllib.error
    import urllib.request

    from pednstream_tpu_torch.mcp.http_server import serve

    httpd, _ = serve(port=0, background=True)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        def get(path):
            with urllib.request.urlopen(base + path, timeout=30) as r:
                return r.status, r.read().decode()

        def post(path, payload):
            req = urllib.request.Request(
                base + path, data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"}, method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read().decode())

        def code_of(call, *args):
            with pytest.raises(urllib.error.HTTPError) as e:
                call(*args)
            return e.value.code

        code, body = get("/tools")
        assert code == 200
        tools = {t["name"]: t for t in json.loads(body)["tools"]}
        assert "run_simulation" in tools
        assert tools["run_simulation"]["parameters"]["properties"]
        assert "device" in tools["create_environment"]["parameters"]["properties"]

        code, env = post("/tools/create_environment",
                         {"config_name": "butterfly_scC", "device": "cpu"})
        assert code == 200 and "sim_id" in env, env
        sim_id = env["sim_id"]
        code, r = post("/tools/run_simulation", {"sim_id": sim_id, "steps": 5})
        assert code == 200 and r["current_step"] == 5, r
        code, st = post("/tools/get_status", {"sim_id": sim_id})
        assert st["status"] in ("CREATED", "RUNNING")

        code, _save = post("/tools/save_outputs", {"sim_id": sim_id})
        code, text = get(f"/resources/sim/{sim_id}/link_data")
        assert code == 200 and text.startswith("{")

        assert code_of(post, "/tools/nonexistent", {}) == 404
        assert code_of(post, "/tools/get_status", {"sim_id": "nosuchsim"}) == 404
        assert code_of(post, "/tools/run_simulation", {"no_such_argument": 1}) == 400
        assert code_of(get, f"/resources/sim/{sim_id}/banana") == 404
        assert code_of(get, "/resources/sim/nosuchsim/link_data") == 404
        assert code_of(get, "/nowhere") == 404
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_mcp_tools(tmp_path):
    r = server.create_environment("nine_intersections", device="cpu")
    assert r["status"] == "CREATED", r
    sid = r["sim_id"]
    r = server.run_simulation(sid, steps=10)
    assert r["current_step"] == 10
    r = server.run_simulation(sid, until=25)
    assert r["current_step"] == 25
    out = server.save_outputs(sid)
    assert os.path.exists(os.path.join(out["output_dir"], "link_data.json"))
    assert server.get_status(sid)["status"] in ("CREATED", "COMPLETED")
    assert server.cancel_simulation(sid)["status"] == "CANCELLED"
    # a cancelled simulation steps no further
    assert server.run_simulation(sid, steps=5)["status"] == "CANCELLED"
    assert server.get_status(sid)["current_step"] == 25

    v = server.validate_config(yaml_text="network: {origin_nodes: [0]}")
    assert not v["valid"]
    v = server.validate_config(yaml_text=server.list_config_schema()["example_yaml"])
    assert v["valid"], v


def test_scripted_agent_client():
    from pednstream_tpu_torch.mcp.agent_client import SimulationAgent
    from pednstream_tpu_torch.mcp.assistant_harness import ScriptedAssistant

    script = [
        {"tool_calls": [{"name": "list_config_schema", "arguments": {}}]},
        {"tool_calls": [{"name": "validate_config", "arguments": {
            "yaml_text": "network:\n  origin_nodes: [0]\n"}}]},
        {"tool_calls": [{"name": "no_such_tool", "arguments": {}}]},
        {"text": "done", "tool_calls": []},
    ]
    agent = SimulationAgent(ScriptedAssistant(script))
    transcript = agent.run("check the schema")
    tools_called = [e["tool"] for e in transcript if "tool" in e]
    assert tools_called == ["list_config_schema", "validate_config", "no_such_tool"]
    assert transcript[-2]["result"] == {"error": "unknown tool no_such_tool"}


# -- the pure-Python tools, exactly the JAX server's ---------------------------

CONFIGS = {
    "flat": FLAT, "nested": NESTED, "bad": BAD, "empty": {},
    "not a dict": [1, 2],
    "stray top-level scalars": {"simulation_steps": 30, "unit_time": 5, "seed": 1,
                                "origin_nodes": [0], "default_link": {"length": 1}},
    "path_finder not a map": {"params": {"path_finder": 3, "simulation_steps": 10}},
    "links not a map": {**NESTED, "links": [1], "od_flows": [2]},
    "od flow array": {**NESTED, "od_flows": {"0_1": [1, 2, 3], "x": "y"}},
    "adjacency not square": {**NESTED, "network": {"origin_nodes": [0],
                                                   "adjacency_matrix": [[0, 1, 0], [1, 0, 1]]}},
    "non-numeric link value": {**NESTED, "default_link": {"length": "long", "width": 3,
                                                          "free_flow_speed": 1.1,
                                                          "k_critical": 2, "k_jam": 6}},
    "float steps": {**NESTED, "simulation": {"simulation_steps": 5.5, "unit_time": 10}},
}


@pytest.mark.parametrize("name", CONFIGS)
def test_normalize_and_validate_equal_the_jax_servers(name):
    cfg = CONFIGS[name]
    assert server.normalize_config(copy.deepcopy(cfg)) == \
        jax_server.normalize_config(copy.deepcopy(cfg))
    assert server.validate_config(config=copy.deepcopy(cfg)) == \
        jax_server.validate_config(config=copy.deepcopy(cfg))


@pytest.mark.parametrize("text", [None, "network: {origin_nodes: [0]}", "a: [1, 2", "",
                                  jax_server._EXAMPLE_YAML],
                         ids=["nothing", "partial", "unparsable", "empty", "example"])
def test_validate_yaml_text_equals_the_jax_servers(text):
    assert server.validate_config(yaml_text=text) == jax_server.validate_config(yaml_text=text)


def test_schema_tools_and_resources_equal_the_jax_servers():
    assert server.list_config_schema() == jax_server.list_config_schema()
    assert list(server.TOOLS) == list(jax_server.TOOLS)
    assert list(server.RESOURCES) == list(jax_server.RESOURCES)
    assert [s.value for s in server.SimulationStatus] == \
        [s.value for s in jax_server.SimulationStatus]
    assert server._sanitize_name("a b/c.d-e_f") == jax_server._sanitize_name("a b/c.d-e_f")


@pytest.mark.parametrize("name", ["flat", "nested", "bad"])
def test_upsert_config_writes_the_jax_servers_yaml(name, tmp_path):
    cfg = CONFIGS[name]
    got = server.upsert_config("my scenario!", config=copy.deepcopy(cfg),
                               data_dir=str(tmp_path / "port"))
    want = jax_server.upsert_config("my scenario!", config=copy.deepcopy(cfg),
                                    data_dir=str(tmp_path / "jax"))
    assert got["saved"] == want["saved"] == (name != "bad")
    if not got["saved"]:
        assert got == want
        assert not (tmp_path / "port").exists()
        return
    assert got["name"] == want["name"] == "my_scenario_"
    assert Path(got["path"]).read_bytes() == Path(want["path"]).read_bytes()
    back = server.read_config("my scenario!", data_dir=str(tmp_path / "port"))
    assert back == jax_server.read_config("my scenario!", data_dir=str(tmp_path / "jax"))
    assert back["found"] and back["config"] == yaml.safe_load(Path(got["path"]).read_text())


def test_read_config_falls_back_to_the_bundled_datasets(tmp_path):
    got = server.read_config("melbourne", data_dir=str(tmp_path))
    assert got["found"] and got["config"]["simulation"]["simulation_steps"] == 500
    assert got == jax_server.read_config("melbourne", data_dir=str(tmp_path))
    assert server.read_config("no_such_dataset", data_dir=str(tmp_path)) == \
        {"found": False, "name": "no_such_dataset"}


def test_tool_specs_equal_the_jax_clients_but_for_device():
    from pednstream_tpu.mcp.agent_client import TOOL_SPECS as JAX_SPECS
    from pednstream_tpu_torch.mcp.agent_client import TOOL_SPECS

    got = copy.deepcopy(TOOL_SPECS)
    create = next(s for s in got if s["name"] == "create_environment")
    device = create["parameters"]["properties"].pop("device")
    assert device["type"] == "string" and "cuda" in device["description"]
    assert "device" not in create["parameters"]["required"]
    # names, parameter schemas and descriptions (each docstring's first
    # paragraph) are the JAX client's
    assert got == JAX_SPECS


# -- a served run against the JAX server's ------------------------------------


def test_deterministic_served_run_and_saved_files_match_the_jax_servers(seeded_data):
    """butterfly_scC created by both servers from the same seeded config,
    each simulation given its package's deterministic ``make_step``, 40
    steps through ``run_simulation``: densities within the port's rollout
    tolerance, the same replies, the same saved file set."""
    import jax

    from pednstream_tpu.engine import make_step as jax_make_step

    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        jr = jax_server.create_environment("butterfly_scC", data_dir=seeded_data)
        assert jr["status"] == "CREATED", jr
        jsim = jax_server._manager.get(jr["sim_id"])
        jsim.step_fn = jax_make_step(jsim.scenario, stochastic=False, record=True)
        jrun = jax_server.run_simulation(jr["sim_id"], steps=40)
        want = np.asarray(jsim.engine_state.density)
        want_peds = np.asarray(jsim.engine_state.num_peds)
        jsave = jax_server.save_outputs(jr["sim_id"])
    finally:
        jax.config.update("jax_enable_x64", prev)

    sid, sim = create(overrides=None, data_dir=seeded_data)
    tr = server._manager.get(sid).to_dict()
    assert {k: v for k, v in jr.items() if k != "sim_id"} == \
        {"status": "CREATED", "num_nodes": sim.scenario.n_nodes,
         "num_links": sim.scenario.n_links, "simulation_steps": 600}
    assert set(tr) == set(jsim.to_dict())
    sim.step_fn = make_step(sim.scenario, stochastic=False, record=True)
    trun = server.run_simulation(sid, steps=40)
    assert {**trun, "sim_id": 0} == {**jrun, "sim_id": 0}
    got = sim.engine_state.density[0].numpy()
    assert want_peds.sum() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_ROLLOUT)
    np.testing.assert_allclose(sim.engine_state.num_peds[0].numpy(), want_peds, rtol=0, atol=1.0)

    tsave = server.save_outputs(sid)
    assert tsave["files"] == jsave["files"]
    assert sorted(os.listdir(tsave["output_dir"])) == sorted(os.listdir(jsave["output_dir"])) \
        == sorted(tsave["files"])
    jlink = json.loads(jax_server.get_link_data(jr["sim_id"]))
    tlink = json.loads(server.get_link_data(sid))
    assert list(tlink) == list(jlink)
    for link in tlink:
        assert list(tlink[link]) == list(jlink[link])
        np.testing.assert_allclose(tlink[link]["density"], jlink[link]["density"], rtol=0,
                                   atol=ATOL_ROLLOUT)
    assert json.loads(server.get_network_params(sid)) == \
        json.loads(jax_server.get_network_params(jr["sim_id"]))
    assert sorted(json.loads(server.get_node_data(sid))) == \
        sorted(json.loads(jax_server.get_node_data(jr["sim_id"])))
    assert server.get_time_series(sid).splitlines()[0] == \
        jax_server.get_time_series(jr["sim_id"]).splitlines()[0]
    without = server.save_outputs(sid, include_time_series=False)
    assert without["files"] == jax_server.save_outputs(jr["sim_id"],
                                                       include_time_series=False)["files"]


def test_overrides_reach_the_scenario(seeded_data):
    """Deep overrides are merged into the config the scenario is built
    from: a seed override gives the demand of the same seed in the file."""
    sid, sim = create(overrides={"params": {"simulation_steps": 50, "seed": 3,
                                            "default_link": {"width": 2.5}}})
    assert sim.total_steps == sim.scenario.simulation_steps == 50
    assert sim.engine_state.cum_in_ring.shape[1] == 51
    assert sim.scenario.params["default_link"]["width"] == 2.5
    assert sim.scenario.params["default_link"]["k_jam"] > 0  # the rest kept
    _, from_file = create(overrides={"params": {"simulation_steps": 50}}, data_dir=seeded_data)
    assert torch.equal(sim.scenario.engine_params.demand,
                       from_file.scenario.engine_params.demand)
    assert float(sim.scenario.engine_params.demand.sum()) > 0


# -- what a threaded server over in-place state must keep ----------------------


def test_recorded_steps_do_not_change_when_later_steps_run():
    sid, sim = create()
    clones = []
    for k in range(5):
        assert server.run_simulation(sid, steps=1)["current_step"] == k + 1
        clones.append({name: getattr(sim.history[k], name).clone()
                       for name in type(sim.history[k]).__dataclass_fields__})
    server.run_simulation(sid, steps=20)
    assert len(sim.history) == 25
    for k, clone in enumerate(clones):
        for name, x in clone.items():
            assert torch.equal(getattr(sim.history[k], name), x), (k, name)
    # and the recorded steps are not all the same step
    assert not torch.equal(sim.history[4].cum_in, sim.history[24].cum_in)


def test_ten_steps_then_ten_equal_twenty_bitwise():
    sid_a, a = create()
    sid_b, b = create()
    assert server.run_simulation(sid_a, steps=10)["current_step"] == 10
    assert server.run_simulation(sid_a, until=20)["current_step"] == 20
    assert server.run_simulation(sid_b, steps=20)["current_step"] == 20
    states_equal(a.engine_state, b.engine_state)
    assert float(a.engine_state.num_peds.sum()) > 0
    for x, y in zip(a.history, b.history):
        assert torch.equal(x.density, y.density) and torch.equal(x.sending, y.sending)
    # the draws matter: a deterministic step ends elsewhere
    sid_c, c = create()
    c.step_fn = make_step(c.scenario, stochastic=False, record=True)
    server.run_simulation(sid_c, steps=20)
    assert not torch.equal(c.engine_state.cum_in, a.engine_state.cum_in)


def test_run_to_the_end_completes_and_until_is_clamped(tmp_path):
    run_workflow(steps=20, data_dir=str(tmp_path), verbose=False, device="cpu")
    r = server.create_environment("mcp_workflow_demo", data_dir=str(tmp_path), device="cpu")
    sid = r["sim_id"]
    T = r["simulation_steps"]
    assert server.run_simulation(sid, until=10 * T) == \
        {"sim_id": sid, "status": "COMPLETED", "current_step": T - 1, "total_steps": T}
    assert server.run_simulation(sid, steps=5)["current_step"] == T - 1
    assert len(server._manager.get(sid).history) == T - 1


def test_cancel_from_another_thread_stops_the_loop():
    sid, sim = create()
    server.run_simulation(sid, steps=2)
    step = sim.step_fn
    calls = []

    def step_then_cancel(ep, st):
        out = step(ep, st)
        calls.append(1)
        if len(calls) == 3:
            t = threading.Thread(target=server.cancel_simulation, args=(sid,))
            t.start()
            t.join()
        return out

    sim.step_fn = step_then_cancel
    r = server.run_simulation(sid, steps=50)
    assert r == {"sim_id": sid, "status": "CANCELLED", "current_step": 5,
                 "total_steps": sim.total_steps}
    assert len(sim.history) == 5 and sim.engine_state.t == 6
    assert server.get_status(sid)["status"] == "CANCELLED"


def test_busy_simulation_replies_instead_of_racing():
    sid, sim = create()
    server.run_simulation(sid, steps=3)
    assert sim.run_lock.acquire(blocking=False)
    try:
        r = server.run_simulation(sid, steps=5)
    finally:
        sim.run_lock.release()
    assert r == {"sim_id": sid, "status": "RUNNING", "current_step": 3,
                 "total_steps": sim.total_steps, "note": "step loop busy in another request"}
    assert sim.engine_state.t == 4 and len(sim.history) == 3
    # the lock was given back: the next request steps
    assert server.run_simulation(sid, steps=5)["current_step"] == 8


def test_a_failing_step_fails_the_call_that_caused_it():
    sid, sim = create()

    def broken(ep, st):
        raise RuntimeError("the device fell over")

    sim.step_fn = broken
    r = server.run_simulation(sid, steps=5)
    assert r == {"sim_id": sid, "status": "FAILED", "error": "the device fell over"}
    assert not sim.run_lock.locked()
    assert server.run_simulation(sid, steps=5)["status"] == "FAILED"


def test_two_simulations_stepped_from_two_threads_equal_themselves_alone():
    names = [("butterfly_scC", SEEDED), ("nine_intersections", None)]
    together = [create(n, o) for n, o in names]
    replies = {}

    def run(sid):
        replies[sid] = [server.run_simulation(sid, steps=15),
                        server.run_simulation(sid, until=30)]

    threads = [threading.Thread(target=run, args=(sid,)) for sid, _ in together]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for (sid, sim), (n, o) in zip(together, names):
        assert [r["current_step"] for r in replies[sid]] == [15, 30]
        sid_alone, alone = create(n, o)
        server.run_simulation(sid_alone, steps=30)
        states_equal(sim.engine_state, alone.engine_state)
        assert float(sim.engine_state.cum_in.sum()) > 0


def test_create_environment_without_a_card_fails_and_never_builds_on_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device resolves")
    r = server.create_environment("butterfly_scC")
    assert r["status"] == "FAILED"
    assert r["error"] == ("device 'cuda' needs a CUDA card and torch sees none; "
                          "pass device='cpu' to run on the CPU")
    sim = server._manager.get(r["sim_id"])
    assert sim.scenario is None and sim.engine_state is None and sim.gen is None
    assert server.run_simulation(r["sim_id"], steps=1) == \
        {"sim_id": r["sim_id"], "status": "FAILED", "error": r["error"]}
    # an unknown dataset fails the same way, with the loader's message
    r = server.create_environment("no_such_dataset", device="cpu")
    assert r["status"] == "FAILED" and "not found" in r["error"]


def test_state_generator_and_history_live_on_the_simulations_device():
    sid, sim = create()
    server.run_simulation(sid, steps=3)
    assert sim.device == torch.device("cpu") == sim.gen.device
    assert sim.engine_state.cum_in_ring.shape == (1, 601, sim.scenario.n_links)
    assert sim.history[0].density.shape == (1, sim.scenario.n_links)
    assert sim.history[0].density.dtype == torch.float32


def test_map_export_and_animation():
    sid, sim = create()
    assert server.export_interactive_map(sid) == {"sim_id": sid,
                                                  "error": "no steps recorded yet"}
    assert server.save_outputs(sid) == {"sim_id": sid, "error": "no steps recorded yet"}
    server.run_simulation(sid, steps=6)
    r = server.export_interactive_map(sid, save_name="map.html")
    assert r["html_path"].endswith("map.html")
    assert Path(r["html_path"]).stat().st_size > 10_000
    r = server.animate(sid, start_time=1, end_time=3, fps=5)
    assert Path(r["animation_path"]).read_bytes()[:3] == b"GIF"
    assert any(s["sim_id"] == sid for s in server.list_simulations()["simulations"])
    with pytest.raises(KeyError, match="Unknown simulation"):
        server.get_status("nosuchsim")


def test_profiling_served_path_on_cpu():
    """``python -m pednstream_tpu_torch.profiling served`` steps a
    simulation of the tool server's by one-step requests; on a CPU device
    it times them and finds no device kernels."""
    from pednstream_tpu_torch.profiling import run

    before = len(server._manager.list())
    out = run("served", device="cpu", dataset="nine_intersections", warm=2, steps=3)
    assert out["path"] == "served" and out["batch"] == 1 and out["steps"] == 3
    assert out["wall_ms_per_step"] > 0
    assert out["kernels_per_step"] == 0 and out["top_kernels"] == []
    sims = server._manager.list()
    assert len(sims) == before + 1 and sims[-1]["current_step"] == 2 + 3 + 3
    with pytest.raises(ValueError, match="one replica"):
        run("served", device="cpu", batch=4)


def test_build_server_needs_fastmcp(monkeypatch):
    monkeypatch.setitem(sys.modules, "fastmcp", None)  # as if not installed
    with pytest.raises(ImportError, match="fastmcp is not installed.*pednstream_tpu_torch"):
        server.build_server()


def test_assistants_are_lazy_imports(monkeypatch):
    from pednstream_tpu_torch.mcp.assistant_harness import ScriptedAssistant, make_assistant

    assert isinstance(make_assistant("scripted", script=[{"text": "x"}]), ScriptedAssistant)
    for provider in ("anthropic", "openai"):
        monkeypatch.setitem(sys.modules, provider, None)
        with pytest.raises(ImportError, match=f"{provider} package not installed"):
            make_assistant(provider)
    with pytest.raises(ValueError, match="unknown provider"):
        make_assistant("nobody")


def test_the_ports_mcp_imports_no_jax():
    code = ("import sys\n"
            "import pednstream_tpu_torch.mcp.server, pednstream_tpu_torch.mcp.http_server\n"
            "import pednstream_tpu_torch.mcp.agent_client, pednstream_tpu_torch.mcp.run_mcp\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'pednstream_tpu')]\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(ROOT), env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
