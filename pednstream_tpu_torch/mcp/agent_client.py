"""LLM-driven simulation agent over the MCP tool surface.

Counterpart of the reference mcp/agent_client.py: an agent loop that
lets an LLM create scenario configs (with authoring guardrails —
validation before write, schema in the system prompt), run simulations,
and request visualizations, by calling the tools in
pednstream_tpu_torch.mcp.server.  Works against the local tool functions
directly (no MCP transport needed) or any Assistant adapter.
"""

import inspect
import json
import typing
from typing import Dict, List, Optional

from ..device import DEFAULT
from . import server
from .assistant_harness import Assistant, make_assistant

SYSTEM_PROMPT = """You are a pedestrian-traffic simulation operator.
You control a Link Transmission Model simulator through tools.

Workflow guardrails:
1. Author or modify scenario configs ONLY through upsert_config, and
   ALWAYS call validate_config first; never write invalid YAML.
2. Use list_config_schema to check field meanings before authoring.
3. Create environments with create_environment, advance them with
   run_simulation (steps= or until=), then save_outputs before
   requesting any visualization or metric.
4. Report simulation status honestly, including FAILED states.
"""

# per-parameter descriptions for the tool schemas (the reference client
# ships real schemas so the LLM knows each tool's arguments)
_PARAM_DESCRIPTIONS = {
    "sim_id": "Simulation id returned by create_environment",
    "config_name": "Dataset/scenario name (e.g. 'butterfly_scC', 'melbourne')",
    "overrides": "Deep config overrides merged into the scenario params",
    "data_dir": "Dataset directory override (default: bundled data/)",
    "device": "Device to simulate on: 'cuda' (default) or 'cpu'",
    "steps": "Number of additional steps to advance",
    "until": "Absolute step to advance to (exclusive with steps)",
    "include_time_series": "Also write time_series.csv",
    "time_step": "Simulation step to render",
    "edge_property": "Link property to color by: density|flow|speed|num_pedestrians",
    "save_name": "Output image filename",
    "start_time": "First animation frame step",
    "end_time": "Last animation frame step",
    "fps": "Animation frames per second",
    "config": "Scenario config as a JSON object (nested or flat form)",
    "cfg": "Scenario config as a JSON object (nested or flat form)",
    "yaml_text": "Scenario config as YAML text (alternative to config)",
    "name": "Scenario name to write/read under the dataset directory",
}


def _json_type(annotation) -> dict:
    if annotation is inspect.Parameter.empty:
        return {}
    origin = typing.get_origin(annotation)
    if origin is typing.Union:  # Optional[...]
        args = [a for a in typing.get_args(annotation) if a is not type(None)]
        return _json_type(args[0]) if args else {}
    if annotation is int:
        return {"type": "integer"}
    if annotation is float:
        return {"type": "number"}
    if annotation is bool:
        return {"type": "boolean"}
    if annotation is str:
        return {"type": "string"}
    if origin in (dict,) or annotation in (dict, Dict):
        return {"type": "object"}
    if origin in (list,) or annotation in (list, List):
        return {"type": "array"}
    return {}


def _tool_spec(name: str, fn) -> dict:
    """Real parameter schema from the tool's signature + annotations."""
    props, required = {}, []
    for pname, p in inspect.signature(fn).parameters.items():
        schema = dict(_json_type(p.annotation))
        desc = _PARAM_DESCRIPTIONS.get(pname)
        if desc:
            schema["description"] = desc
        props[pname] = schema or {"description": desc or pname}
        if p.default is inspect.Parameter.empty:
            required.append(pname)
    params = {"type": "object", "properties": props}
    if required:
        params["required"] = required
    return {"name": name,
            "description": (fn.__doc__ or "").strip().split("\n\n")[0],
            "parameters": params}


TOOL_SPECS = [_tool_spec(name, fn) for name, fn in server.TOOLS.items()]


class SimulationAgent:
    def __init__(self, assistant: Optional[Assistant] = None, max_turns: int = 16):
        self.assistant = assistant or make_assistant("scripted", script=[])
        self.max_turns = max_turns
        self.transcript: List[dict] = []

    def run(self, task: str) -> List[dict]:
        """Drive the assistant until it stops calling tools."""
        messages = [{"role": "user", "content": f"{SYSTEM_PROMPT}\n\nTask: {task}"}]
        for _ in range(self.max_turns):
            reply = self.assistant.chat(messages, TOOL_SPECS)
            self.transcript.append({"assistant": reply["text"],
                                    "tool_calls": reply["tool_calls"]})
            if not reply["tool_calls"]:
                break
            results = []
            for call in reply["tool_calls"]:
                fn = server.TOOLS.get(call["name"])
                if fn is None:
                    result = {"error": f"unknown tool {call['name']}"}
                else:
                    try:
                        result = fn(**(call["arguments"] or {}))
                    except Exception as e:
                        result = {"error": str(e)}
                results.append({"tool": call["name"], "result": result})
                self.transcript.append(results[-1])
            messages.append({"role": "assistant", "content": reply["text"] or "(tool calls)"})
            messages.append({
                "role": "user",
                "content": "Tool results:\n" + json.dumps(results, default=str)[:8000],
            })
        return self.transcript


def example_workflow(device: str = DEFAULT):
    """Scripted end-to-end example (counterpart of mcp/run_mcp.py):
    create -> run -> save -> snapshot, without an LLM."""
    from .assistant_harness import ScriptedAssistant

    script = [
        {"text": "creating environment",
         "tool_calls": [{"name": "create_environment",
                         "arguments": {"config_name": "butterfly_scC",
                                       "device": device}}]},
        {"text": "running", "tool_calls": []},
    ]
    agent = SimulationAgent(ScriptedAssistant(script))
    transcript = agent.run("Simulate the butterfly scenario for 50 steps")
    sim_id = None
    for entry in transcript:
        if entry.get("tool") == "create_environment":
            sim_id = entry["result"].get("sim_id")
    if sim_id:
        print(server.run_simulation(sim_id, steps=50))
        print(server.save_outputs(sim_id))
    return transcript


if __name__ == "__main__":
    example_workflow()
