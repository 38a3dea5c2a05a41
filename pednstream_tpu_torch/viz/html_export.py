"""Self-contained interactive HTML map export (the counterpart of
``pednstream_tpu/viz/html_export.py``, which writes the same file).

Replaces the reference dashboard's browser stack (Streamlit + folium +
Selenium/Chrome screenshot pipeline, network_dashboard.py:206-500) with
a ZERO-dependency artifact: one HTML file embedding the network geometry
and the per-link time series, rendered as SVG with a vanilla-JS time
slider, play button, and property selector.  Works from any saved run
directory (both this engine's and the reference's output formats) and
needs only a browser to view — no server, no Python environment.
"""

import json
from pathlib import Path
from typing import List, Optional

import numpy as np

from .visualizer import NetworkVisualizer

_PROPS = ["density", "flow", "speed", "num_pedestrians", "travel_time"]

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>PedNStream-TPU — {title}</title>
<style>
 body {{ font-family: sans-serif; margin: 1em; background: #fafafa; }}
 svg {{ background: white; border: 1px solid #ddd; }}
 .controls {{ margin: .6em 0; display: flex; gap: 1em; align-items: center; }}
 .legend {{ font-size: 12px; color: #444; }}
 #tlabel {{ min-width: 9em; display: inline-block; }}
</style></head><body>
<h3>{title}</h3>
<div class="controls">
 <button id="play">&#9654;</button>
 <input type="range" id="t" min="0" max="{tmax}" value="0" style="flex:1">
 <span id="tlabel"></span>
 <select id="prop">{prop_options}</select>
</div>
<svg id="net" viewBox="0 0 {w} {h}" width="100%" height="640">{svg_body}</svg>
<div class="legend">color: green = low &rarr; red = high (scale per property);
 arrows offset per direction; circles = nodes (black = origin, double ring =
 destination)</div>
<script>
const DATA = {data_json};      // prop -> [T][E] quantized 0..255
const SCALES = {scales_json};  // prop -> max value
const EDGES = {n_edges};
const T = {tmax} + 1;
const dt = {unit_time};
const slider = document.getElementById('t');
const label = document.getElementById('tlabel');
const propSel = document.getElementById('prop');
function color(q) {{
  // green -> yellow -> red
  const x = q / 255;
  const r = Math.round(255 * Math.min(1, 2 * x));
  const g = Math.round(255 * Math.min(1, 2 * (1 - x)));
  return `rgb(${{r}},${{g}},60)`;
}}
function render() {{
  const t = +slider.value, p = propSel.value;
  label.textContent = `t = ${{t}} (${{(t * dt).toFixed(0)}} s)`;
  const frame = DATA[p][t];
  for (let e = 0; e < EDGES; e++) {{
    const el = document.getElementById('e' + e);
    el.setAttribute('stroke', color(frame[e]));
    el.setAttribute('stroke-width', 1.5 + 3.5 * frame[e] / 255);
  }}
}}
slider.oninput = render; propSel.onchange = render;
let timer = null;
document.getElementById('play').onclick = function () {{
  if (timer) {{ clearInterval(timer); timer = null; this.innerHTML = '&#9654;'; return; }}
  this.innerHTML = '&#9646;&#9646;';
  timer = setInterval(() => {{
    slider.value = (+slider.value + 1) % T; render();
  }}, 80);
}};
render();
</script></body></html>
"""


def export_interactive_html(
    simulation_dir: Optional[str] = None,
    out_path: str = "network_map.html",
    properties: Optional[List[str]] = None,
    scenario=None,
    history=None,
    title: Optional[str] = None,
    max_frames: int = 600,
) -> str:
    """Write a standalone interactive HTML map of a simulation run.

    Values are quantized to uint8 against each property's max so the
    file stays compact (~T*E bytes per property before JSON overhead).
    """
    viz = NetworkVisualizer(scenario=scenario, history=history,
                            simulation_dir=simulation_dir)
    props = [p for p in (properties or _PROPS)
             if any(p in d for d in viz.link_data.values())]
    edges = viz.edges
    keys = list(viz.link_data.keys())
    T = min(int(viz.simulation_steps or 1), max_frames)

    # geometry: scale positions into an SVG canvas
    pos = viz.pos
    xs = np.array([pos[str(u)][0] for u, v in edges] +
                  [pos[str(v)][0] for u, v in edges])
    ys = np.array([pos[str(u)][1] for u, v in edges] +
                  [pos[str(v)][1] for u, v in edges])
    W, H, pad = 1000.0, 640.0, 40.0

    def sx(x):
        rng = xs.max() - xs.min() or 1.0
        return pad + (x - xs.min()) / rng * (W - 2 * pad)

    def sy(y):
        rng = ys.max() - ys.min() or 1.0
        return H - pad - (y - ys.min()) / rng * (H - 2 * pad)

    # SVG edges, offset per direction so bidirectional pairs are visible
    parts = []
    for e, (u, v) in enumerate(edges):
        x1, y1 = sx(pos[str(u)][0]), sy(pos[str(u)][1])
        x2, y2 = sx(pos[str(v)][0]), sy(pos[str(v)][1])
        dx, dy = x2 - x1, y2 - y1
        norm = (dx * dx + dy * dy) ** 0.5 or 1.0
        ox, oy = -dy / norm * 3.0, dx / norm * 3.0  # left offset
        parts.append(
            f'<line id="e{e}" x1="{x1+ox:.1f}" y1="{y1+oy:.1f}" '
            f'x2="{x2+ox:.1f}" y2="{y2+oy:.1f}" stroke="#888" '
            f'stroke-width="2"><title>{u}&#8594;{v}</title></line>'
        )
    origin = set(map(int, viz.network_params.get("origin_nodes", []) or []))
    dest = set(map(int, viz.network_params.get("destination_nodes", []) or []))
    for n in {u for u, v in edges} | {v for u, v in edges}:
        x, y = sx(pos[str(n)][0]), sy(pos[str(n)][1])
        fill = "black" if n in origin else "#666"
        ring = (f'<circle cx="{x:.1f}" cy="{y:.1f}" r="9" fill="none" '
                f'stroke="#333"/>' if n in dest else "")
        parts.append(f'{ring}<circle cx="{x:.1f}" cy="{y:.1f}" r="6" '
                     f'fill="{fill}"/><text x="{x+8:.1f}" y="{y-8:.1f}" '
                     f'font-size="11">{n}</text>')

    # quantized per-property frames
    data, scales = {}, {}
    for p in props:
        series = np.stack([
            np.asarray(viz.link_data[k].get(p, [0.0]), dtype=np.float64)[:T]
            for k in keys
        ])  # [E, <=T]
        if series.shape[1] < T:
            series = np.pad(series, ((0, 0), (0, T - series.shape[1])),
                            mode="edge")
        smax = float(np.nanmax(series)) or 1.0
        q = np.clip(series / smax * 255.0, 0, 255).astype(np.uint8)
        data[p] = q.T.tolist()  # [T][E]
        scales[p] = smax

    html = _TEMPLATE.format(
        title=title or (Path(simulation_dir).name if simulation_dir else "run"),
        tmax=T - 1,
        w=int(W), h=int(H),
        unit_time=float(viz.network_params.get("unit_time", 1.0)),
        prop_options="".join(f'<option value="{p}">{p}</option>' for p in props),
        svg_body="".join(parts),
        data_json=json.dumps(data, separators=(",", ":")),
        scales_json=json.dumps(scales),
        n_edges=len(edges),
    )
    Path(out_path).write_text(html)
    return out_path


def main():
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--sim-dir", required=True)
    p.add_argument("--out", default="network_map.html")
    p.add_argument("--max-frames", type=int, default=600)
    args = p.parse_args()
    path = export_interactive_html(simulation_dir=args.sim_dir,
                                   out_path=args.out,
                                   max_frames=args.max_frames)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
