"""Minimal HTTP transport for the MCP tool surface (stdlib only).

The reference serves its tools over FastMCP's HTTP transport and smoke-
tests it with mcp/test_http_client.py.  FastMCP is an optional package,
so this module exposes the same tool registry over a plain
ThreadingHTTPServer — enough for any HTTP client (or LLM harness) to
drive simulations remotely, and for tests/test_torch_mcp.py to smoke the
live-socket path.  Each request is answered on a thread of its own:
simulations step concurrently, each on its own state and generator, and
the kernel library is built and loaded once under a lock.

  POST /tools/<name>          body: JSON kwargs   -> JSON result
  GET  /tools                                     -> tool list + schemas
  GET  /resources/sim/<id>/<resource>             -> raw resource text

Run:  python -m pednstream_tpu_torch.mcp.http_server [--port 8765]
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

from . import server as toolsrv

_RESOURCE_FNS = {
    "link_data": toolsrv.get_link_data,
    "node_data": toolsrv.get_node_data,
    "network_params": toolsrv.get_network_params,
    "time_series": toolsrv.get_time_series,
}


class _Handler(BaseHTTPRequestHandler):
    def _send(self, code: int, body: str, ctype: str = "application/json"):
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *args):  # quiet
        pass

    def do_GET(self):
        parts = [p for p in self.path.split("/") if p]
        if parts == ["tools"]:
            from .agent_client import TOOL_SPECS

            self._send(200, json.dumps({"tools": TOOL_SPECS}))
        elif len(parts) == 4 and parts[:2] == ["resources", "sim"]:
            sim_id, resource = parts[2], parts[3]
            fn = _RESOURCE_FNS.get(resource)
            if fn is None:
                self._send(404, json.dumps({"error": f"unknown resource {resource}"}))
                return
            try:
                self._send(200, fn(sim_id), ctype="text/plain")
            except KeyError as e:
                self._send(404, json.dumps({"error": str(e)}))
        else:
            self._send(404, json.dumps({"error": "not found"}))

    def do_POST(self):
        parts = [p for p in self.path.split("/") if p]
        if len(parts) != 2 or parts[0] != "tools":
            self._send(404, json.dumps({"error": "POST /tools/<name>"}))
            return
        fn = toolsrv.TOOLS.get(parts[1])
        if fn is None:
            self._send(404, json.dumps({"error": f"unknown tool {parts[1]}"}))
            return
        length = int(self.headers.get("Content-Length", 0))
        try:
            kwargs = json.loads(self.rfile.read(length) or b"{}")
            result = fn(**kwargs)
            self._send(200, json.dumps(result, default=str))
        except KeyError as e:
            # unknown sim_id etc. — a client error, mirroring the GET
            # resource path's 404
            self._send(404, json.dumps({"error": str(e)}))
        except TypeError as e:
            self._send(400, json.dumps({"error": f"bad arguments: {e}"}))
        except Exception as e:
            self._send(500, json.dumps({"error": str(e)}))


def serve(port: int = 8765, host: str = "127.0.0.1",
          background: bool = False) -> Tuple[ThreadingHTTPServer, Optional[threading.Thread]]:
    """Start the HTTP tool server; port=0 picks an ephemeral port."""
    httpd = ThreadingHTTPServer((host, port), _Handler)
    if background:
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        return httpd, thread
    print(f"serving MCP tools on http://{host}:{httpd.server_address[1]}")
    httpd.serve_forever()
    return httpd, None


def main():
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--host", default="127.0.0.1")
    args = p.parse_args()
    serve(port=args.port, host=args.host)


if __name__ == "__main__":
    main()
