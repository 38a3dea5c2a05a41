"""End-to-end MCP workflow client (counterpart of the reference
mcp/run_mcp.py): drives the full tool surface without an LLM —
author a scenario config (validate -> upsert -> read back), create the
environment, advance it in two resumable chunks, save outputs, render a
snapshot (where matplotlib is installed), and read a data resource.  Doubles as the workflow test
(tests/test_torch_mcp.py) and as a usage example:

    python -m pednstream_tpu_torch.mcp.run_mcp [--config-name NAME] [--steps N]
        [--device cuda|cpu]
"""

import argparse
import importlib.util
import json
import tempfile

from ..device import DEFAULT
from . import server


def run_workflow(config_name: str = None, steps: int = 40,
                 data_dir: str = None, verbose: bool = True,
                 device: str = DEFAULT) -> dict:
    """Returns a dict of every tool result, raising on any failure."""
    log = {}

    def call(tool, **kw):
        result = server.TOOLS[tool](**kw)
        log.setdefault(tool, []).append(result)
        if verbose:
            print(f"{tool}: {json.dumps(result, default=str)[:200]}")
        if isinstance(result, dict) and result.get("error"):
            raise RuntimeError(f"{tool} failed: {result['error']}")
        return result

    authored_dir = data_dir or tempfile.mkdtemp(prefix="mcp_cfg_")
    if config_name is None:
        # author a scenario through the config tools, exercising the
        # legacy-key normalization (flat loader form in, nested form out)
        config_name = "mcp_workflow_demo"
        flat_cfg = {
            "params": {
                "simulation_steps": max(steps + 10, 60),
                "unit_time": 10,
                "seed": 0,
                "default_link": {"length": 60, "width": 4,
                                 "free_flow_speed": 1.1,
                                 "k_critical": 2, "k_jam": 6},
            },
            "origin_nodes": [0],
            "destination_nodes": [2],
            "adjacency_matrix": [[0, 1, 0], [1, 0, 1], [0, 1, 0]],
            "demand": {"origin_0": {"pattern": "constant", "base_lambda": 8}},
        }
        schema = call("list_config_schema")
        assert "schema" in schema
        v = call("validate_config", config=flat_cfg)
        assert v["valid"], v["errors"]
        call("upsert_config", name=config_name, config=flat_cfg,
             data_dir=authored_dir)
        rb = call("read_config", name=config_name, data_dir=authored_dir)
        assert rb["found"] and "simulation" in rb["config"]

    env = call("create_environment", config_name=config_name,
               data_dir=authored_dir if config_name == "mcp_workflow_demo" else data_dir,
               device=device)
    sim_id = env["sim_id"]

    # resumable stepping: two chunks through the cached step
    call("run_simulation", sim_id=sim_id, steps=steps // 2)
    st = call("get_status", sim_id=sim_id)
    assert st["current_step"] == steps // 2
    call("run_simulation", sim_id=sim_id, until=steps)
    st = call("get_status", sim_id=sim_id)
    assert st["current_step"] == steps

    call("save_outputs", sim_id=sim_id)
    if importlib.util.find_spec("matplotlib") is None:
        # the tool itself raises ImportError there; the workflow says so
        # and goes on
        log["visualize_snapshot"] = [{"skipped": "matplotlib is not installed"}]
        if verbose:
            print("visualize_snapshot: skipped, matplotlib is not installed")
    else:
        call("visualize_snapshot", sim_id=sim_id, time_step=steps - 1)
    link_data = server.get_link_data(sim_id)
    assert link_data.startswith("{")
    sims = call("list_simulations")
    assert any(s["sim_id"] == sim_id for s in sims["simulations"])
    return log


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config-name", default=None,
                   help="existing dataset name; default authors a new one")
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--device", default=DEFAULT,
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args()
    run_workflow(config_name=args.config_name, steps=args.steps, device=args.device)
    print("workflow complete")


if __name__ == "__main__":
    main()
