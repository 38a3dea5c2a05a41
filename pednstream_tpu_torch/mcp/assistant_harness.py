"""LLM assistant adapters for the MCP tool surface.

Counterpart of the reference mcp/assistant_harness.py: provider-agnostic
chat adapters (Anthropic / OpenAI) exposing a single ``chat(messages,
tools)`` interface used by the agent client.  Providers are optional
imports; a deterministic ScriptedAssistant is included for tests and
offline use.
"""

import json
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional


class Assistant(ABC):
    @abstractmethod
    def chat(self, messages: List[dict], tools: List[dict]) -> dict:
        """Returns {'text': str, 'tool_calls': [{'name', 'arguments'}]}"""


class AnthropicAssistant(Assistant):
    def __init__(self, model: str = "claude-sonnet-4-5", api_key: Optional[str] = None):
        try:
            import anthropic
        except ImportError as e:
            raise ImportError("anthropic package not installed") from e
        self.client = anthropic.Anthropic(api_key=api_key)
        self.model = model

    def chat(self, messages, tools):
        anth_tools = [
            {"name": t["name"], "description": t.get("description", ""),
             "input_schema": t.get("parameters", {"type": "object", "properties": {}})}
            for t in tools
        ]
        resp = self.client.messages.create(
            model=self.model, max_tokens=2048, messages=messages, tools=anth_tools
        )
        text = "".join(b.text for b in resp.content if b.type == "text")
        calls = [{"name": b.name, "arguments": b.input}
                 for b in resp.content if b.type == "tool_use"]
        return {"text": text, "tool_calls": calls}


class OpenAIAssistant(Assistant):
    def __init__(self, model: str = "gpt-4o", api_key: Optional[str] = None):
        try:
            import openai
        except ImportError as e:
            raise ImportError("openai package not installed") from e
        self.client = openai.OpenAI(api_key=api_key)
        self.model = model

    def chat(self, messages, tools):
        oai_tools = [
            {"type": "function", "function": {
                "name": t["name"], "description": t.get("description", ""),
                "parameters": t.get("parameters", {"type": "object", "properties": {}}),
            }} for t in tools
        ]
        resp = self.client.chat.completions.create(
            model=self.model, messages=messages, tools=oai_tools
        )
        msg = resp.choices[0].message
        calls = [
            {"name": tc.function.name, "arguments": json.loads(tc.function.arguments)}
            for tc in (msg.tool_calls or [])
        ]
        return {"text": msg.content or "", "tool_calls": calls}


class ScriptedAssistant(Assistant):
    """Deterministic assistant replaying a fixed tool-call script; used to
    test the agent loop without any LLM API."""

    def __init__(self, script: List[Dict[str, Any]]):
        self.script = list(script)

    def chat(self, messages, tools):
        if not self.script:
            return {"text": "done", "tool_calls": []}
        step = self.script.pop(0)
        return {"text": step.get("text", ""), "tool_calls": step.get("tool_calls", [])}


def make_assistant(provider: str = "scripted", **kwargs) -> Assistant:
    if provider == "anthropic":
        return AnthropicAssistant(**kwargs)
    if provider == "openai":
        return OpenAIAssistant(**kwargs)
    if provider == "scripted":
        return ScriptedAssistant(kwargs.get("script", []))
    raise ValueError(f"unknown provider {provider}")
