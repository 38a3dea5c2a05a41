"""Network visualization: snapshots, animations, OD paths, link evolution
(the counterpart of ``pednstream_tpu/viz/visualizer.py``; host code on
numpy, with matplotlib, networkx and folium imported where a method needs
them).

Plays the role of the reference NetworkVisualizer (src/utils/visualizer.py
:12-1004): works from a live scenario+trajectory or from a saved
simulation directory (either engine's output — formats match), renders
per-link state as colored directed edges (curved for bidirectional
pairs), animates over time with gate/separator aperture glyphs, and
plots OD paths and per-link time series.  Folium map rendering
(visualizer.py:253-424) is available when folium is installed.
"""

import json
from pathlib import Path
from typing import List, Optional

import numpy as np


def progress_callback(current_frame: int, total_frames: int):
    if total_frames and current_frame % max(1, total_frames // 10) == 0:
        print(f"animation: {current_frame}/{total_frames}")


class NetworkVisualizer:
    def __init__(self, scenario=None, state=None, history=None,
                 simulation_dir: Optional[str] = None, pos: Optional[dict] = None,
                 network=None):
        """Create from a saved run dir OR a live scenario (+ recorded
        history, whose tensors the output handler moves to the host once).
        ``network`` is accepted as an alias for scenario and ``state`` is
        accepted and unused, for reference API compatibility."""
        scenario = scenario or network
        self.pos = pos
        if simulation_dir is not None:
            self._load_dir(simulation_dir)
        elif scenario is not None:
            self._load_scenario(scenario, history)
        else:
            raise ValueError("need simulation_dir or scenario")
        if self.pos is None:
            self.pos = self._spring_layout()

    # -- data ingestion -------------------------------------------------------

    def _load_dir(self, simulation_dir):
        p = Path(simulation_dir)
        with open(p / "link_data.json") as f:
            self.link_data = json.load(f)
        with open(p / "network_params.json") as f:
            self.network_params = json.load(f)
        node_file = p / "node_data.json"
        self.node_data = json.loads(node_file.read_text()) if node_file.exists() else {}
        self.simulation_steps = self.network_params.get("simulation_steps")
        self.edges = [tuple(map(int, k.split("-"))) for k in self.link_data]

    def _load_scenario(self, scn, history):
        """Convert a live run to the saved-dict format in memory."""
        import tempfile

        from ..io.output_handler import OutputHandler

        if history:
            with tempfile.TemporaryDirectory() as td:
                handler = OutputHandler(base_dir=td, simulation_dir="live")
                handler.save_scenario_state(scn, history)
                self._load_dir(handler.simulation_dir)
        else:
            # topology-only view
            self.link_data = {
                f"{int(u)}-{int(v)}": {"density": [0.0]}
                for (u, v) in scn.topo.link_nodes
            }
            self.network_params = {
                "simulation_steps": scn.simulation_steps,
                "unit_time": scn.unit_time,
                "origin_nodes": scn.origin_nodes,
                "destination_nodes": scn.destination_nodes,
                "od_paths": {},
            }
            self.node_data = {}
            self.simulation_steps = scn.simulation_steps
            self.edges = [tuple(map(int, k.split("-"))) for k in self.link_data]
        if self.pos is None and scn.pos is not None:
            self.pos = {str(k): v for k, v in scn.pos.items()}

    def _spring_layout(self):
        import networkx as nx

        g = nx.DiGraph()
        g.add_edges_from(self.edges)
        pos = nx.spring_layout(g, k=1, iterations=50, seed=0)
        return {str(n): (float(x), float(y)) for n, (x, y) in pos.items()}

    def _series(self, link_key: str, prop: str) -> np.ndarray:
        return np.asarray(self.link_data[link_key].get(prop, [0.0]))

    # -- static snapshot (visualizer.py:73-251) --------------------------------

    _PROP_RANGES = {
        "density": (0.0, 6.0), "flow": (0.0, 5.0), "link_flow": (0.0, 5.0),
        "speed": (0.0, 1.5), "num_pedestrians": (0.0, 300.0),
        "travel_time": (0.0, 500.0),
    }

    def visualize_network_state(self, time_step: int, edge_property: str = "density",
                                with_colorbar: bool = True, set_title: bool = True,
                                figsize=(10, 8), ax=None, save_path: Optional[str] = None):
        import matplotlib.pyplot as plt
        import matplotlib
        from matplotlib import cm, colors as mcolors
        from matplotlib.patches import FancyArrowPatch

        own_fig = ax is None
        if ax is None:
            fig, ax = plt.subplots(figsize=figsize)
        else:
            fig = ax.figure
        prop = "link_flow" if edge_property == "flow" else edge_property
        vmin, vmax = self._PROP_RANGES.get(prop, (0.0, 1.0))
        cmap = matplotlib.colormaps["RdYlGn_r"]
        norm = mcolors.Normalize(vmin=vmin, vmax=vmax)

        # nodes
        xs = {n: self.pos[str(n)] for (u, v) in self.edges for n in (u, v) if str(n) in self.pos}
        for n, (x, y) in xs.items():
            ax.scatter([x], [y], s=120, c="lightblue", zorder=3)
            ax.annotate(str(n), (x, y), ha="center", va="center", fontsize=7, zorder=4)

        for (u, v) in self.edges:
            key = f"{u}-{v}"
            series = self._series(key, prop)
            t = min(time_step, len(series) - 1)
            val = series[t]
            p1, p2 = np.array(xs[u]), np.array(xs[v])
            bidir = (v, u) in set(self.edges)
            arrow = FancyArrowPatch(
                p1, p2, connectionstyle=f"arc3,rad={0.15 if bidir else 0.0}",
                arrowstyle="-|>", mutation_scale=8, shrinkA=10, shrinkB=10,
                color=cmap(norm(val)), linewidth=2.0, zorder=2,
            )
            ax.add_patch(arrow)

        if with_colorbar:
            sm = cm.ScalarMappable(norm=norm, cmap=cmap)
            fig.colorbar(sm, ax=ax, label=prop)
        if set_title:
            ax.set_title(f"{prop} at t={time_step}")
        ax.set_axis_off()
        if save_path:
            fig.savefig(save_path, bbox_inches="tight", dpi=120)
            if own_fig:
                plt.close(fig)
        return ax

    # -- animation (visualizer.py:431-705) --------------------------------------

    def animate_network(self, start_time: int = 0, end_time: Optional[int] = None,
                        interval: int = 100, edge_property: str = "density",
                        tag: bool = False, vis_actions: bool = False, figsize=(10, 8)):
        import matplotlib.pyplot as plt
        import matplotlib
        from matplotlib import cm, colors as mcolors
        from matplotlib.animation import FuncAnimation
        from matplotlib.patches import FancyArrowPatch

        prop = "link_flow" if edge_property == "flow" else edge_property
        if end_time is None:
            end_time = min(
                self.simulation_steps or 0,
                max(len(self._series(k, prop)) - 1 for k in self.link_data),
            )
        vmin, vmax = self._PROP_RANGES.get(prop, (0.0, 1.0))
        cmap = matplotlib.colormaps["RdYlGn_r"]
        norm = mcolors.Normalize(vmin=vmin, vmax=vmax)

        fig, ax = plt.subplots(figsize=figsize)
        xs = {n: self.pos[str(n)] for (u, v) in self.edges for n in (u, v) if str(n) in self.pos}
        for n, (x, y) in xs.items():
            ax.scatter([x], [y], s=120, c="lightblue", zorder=3)
            ax.annotate(str(n), (x, y), ha="center", va="center", fontsize=7, zorder=4)

        patches = {}
        edge_set = set(self.edges)
        for (u, v) in self.edges:
            p1, p2 = np.array(xs[u]), np.array(xs[v])
            arrow = FancyArrowPatch(
                p1, p2, connectionstyle=f"arc3,rad={0.15 if (v, u) in edge_set else 0.0}",
                arrowstyle="-|>", mutation_scale=8, shrinkA=10, shrinkB=10,
                color="gray", linewidth=2.0, zorder=2,
            )
            ax.add_patch(arrow)
            patches[(u, v)] = arrow

        # gate/separator aperture glyphs (visualizer.py:918-980)
        glyphs = {}
        if vis_actions:
            for (u, v) in self.edges:
                info = self.link_data[f"{u}-{v}"]
                if "back_gate_width" in info or info.get("is_separator"):
                    p1, p2 = np.array(xs[u]), np.array(xs[v])
                    mid = p1 + 0.8 * (p2 - p1)
                    (glyph,) = ax.plot([mid[0]], [mid[1]], marker="s",
                                       color="purple", markersize=4, zorder=5)
                    glyphs[(u, v)] = glyph

        sm = cm.ScalarMappable(norm=norm, cmap=cmap)
        fig.colorbar(sm, ax=ax, label=prop)
        title = ax.set_title("")
        ax.set_axis_off()

        def update(t):
            for (u, v), arrow in patches.items():
                series = self._series(f"{u}-{v}", prop)
                val = series[min(t, len(series) - 1)]
                arrow.set_color(cmap(norm(val)))
            for (u, v), glyph in glyphs.items():
                info = self.link_data[f"{u}-{v}"]
                widths = info.get("separator_width", info.get("back_gate_width"))
                if widths:
                    w = widths[min(t, len(widths) - 1)]
                    total = info.get("parameters", {}).get("width", 1.0)
                    glyph.set_markersize(2 + 8 * (w / max(total, 1e-6)))
            title.set_text(f"{prop} at t={t}")
            return list(patches.values())

        return FuncAnimation(fig, update, frames=range(start_time, end_time),
                             interval=interval, blit=False)

    # -- od paths (visualizer.py:707-860) ------------------------------------------

    def plot_od_paths(self, od_pair: Optional[str] = None, figsize=(10, 8),
                      save_path: Optional[str] = None):
        import matplotlib.pyplot as plt

        ax = self.visualize_network_state(0, with_colorbar=False, set_title=False,
                                          figsize=figsize)
        od_paths = self.network_params.get("od_paths", {})
        items = od_paths.items() if od_pair is None else [(od_pair, od_paths.get(od_pair, []))]
        colors = plt.cm.tab10.colors
        for i, (od, paths) in enumerate(items):
            for path in paths:
                pts = np.array([self.pos[str(n)] for n in path])
                ax.plot(pts[:, 0], pts[:, 1], color=colors[i % 10], linewidth=3,
                        alpha=0.5, label=od)
        handles, labels = ax.get_legend_handles_labels()
        uniq = dict(zip(labels, handles))
        if uniq:
            ax.legend(uniq.values(), uniq.keys())
        if save_path:
            ax.figure.savefig(save_path, bbox_inches="tight", dpi=120)
        return ax

    # -- link evolution (visualizer.py:862-916) --------------------------------------

    def plot_link_evolution(self, link_keys: List[str],
                            properties=("density", "inflow", "outflow"),
                            figsize=(12, 8), save_path: Optional[str] = None):
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(len(properties), 1, figsize=figsize, sharex=True)
        if len(properties) == 1:
            axes = [axes]
        for ax, prop in zip(axes, properties):
            for key in link_keys:
                if key in self.link_data:
                    ax.plot(self._series(key, prop), label=key)
            ax.set_ylabel(prop)
            ax.legend(fontsize=7)
        axes[-1].set_xlabel("time step")
        if save_path:
            fig.savefig(save_path, bbox_inches="tight", dpi=120)
        return fig

    # -- folium (visualizer.py:253-424), optional --------------------------------------

    def visualize_network_folium(self, time_step: int, edge_property: str = "density"):
        try:
            import folium
        except ImportError as e:
            raise ImportError(
                "folium is not installed; map rendering needs `pip install folium`"
            ) from e
        import matplotlib
        from matplotlib import cm, colors as mcolors

        prop = "link_flow" if edge_property == "flow" else edge_property
        vmin, vmax = self._PROP_RANGES.get(prop, (0.0, 1.0))
        cmap = matplotlib.colormaps["RdYlGn_r"]
        norm = mcolors.Normalize(vmin=vmin, vmax=vmax)
        lats = [self.pos[str(n)][1] for (u, v) in self.edges for n in (u, v)]
        lons = [self.pos[str(n)][0] for (u, v) in self.edges for n in (u, v)]
        m = folium.Map(location=[np.mean(lats), np.mean(lons)], zoom_start=15)
        for (u, v) in self.edges:
            series = self._series(f"{u}-{v}", prop)
            val = series[min(time_step, len(series) - 1)]
            color = mcolors.to_hex(cmap(norm(val)))
            folium.PolyLine(
                [(self.pos[str(u)][1], self.pos[str(u)][0]),
                 (self.pos[str(v)][1], self.pos[str(v)][0])],
                color=color, weight=4, tooltip=f"{u}->{v}: {val:.2f}",
            ).add_to(m)
        return m
