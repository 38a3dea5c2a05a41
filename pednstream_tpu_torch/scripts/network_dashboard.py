"""Interactive simulation dashboard over a saved run (the counterpart of
``network_dashboard.py``; reference network_dashboard.py:28-525).  It reads
saved runs and touches no device.

    streamlit run pednstream_tpu_torch/scripts/network_dashboard.py -- --sim-dir outputs/<run>

Streamlit is optional; without it the headless exports still work:

    python -m pednstream_tpu_torch.scripts.network_dashboard --sim-dir outputs/<run> --html map.html
    python -m pednstream_tpu_torch.scripts.network_dashboard --sim-dir outputs/<run> --video out.mp4
"""

import argparse
import sys


def generate_video(sim_dir: str, out_path: str, edge_property: str = "density",
                   fps: int = 10, start: int = 0, end: int = None):
    """Render the run to an mp4/gif via matplotlib."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib.animation import FFMpegWriter, PillowWriter

    from ..viz import NetworkVisualizer, progress_callback

    viz = NetworkVisualizer(simulation_dir=sim_dir)
    ani = viz.animate_network(start_time=start, end_time=end, edge_property=edge_property)
    if out_path.endswith(".gif"):
        writer = PillowWriter(fps=fps)
    else:
        writer = FFMpegWriter(fps=fps, bitrate=2000)
    ani.save(out_path, writer=writer, progress_callback=progress_callback)
    return out_path


def run_dashboard(sim_dir: str):
    """Streamlit dashboard (network_dashboard.py:375-500)."""
    try:
        import streamlit as st
    except ImportError:
        print("streamlit is not installed; use --video for headless export",
              file=sys.stderr)
        sys.exit(1)
    import matplotlib.pyplot as plt

    from ..io import OutputHandler
    from ..viz import NetworkVisualizer

    st.set_page_config(page_title="PedNStream-TPU dashboard", layout="wide")
    st.title("Pedestrian network simulation")

    data = OutputHandler.load_simulation(sim_dir)
    params = data["network_params"]
    T = params["simulation_steps"]

    col1, col2 = st.columns([3, 1])
    with col2:
        prop = st.selectbox("property", ["density", "flow", "speed",
                                         "num_pedestrians", "travel_time"])
        t = st.slider("time step", 0, T - 1, 0)
        link_keys = st.multiselect("links", sorted(data["link_data"].keys()))
    with col1:
        viz = NetworkVisualizer(simulation_dir=sim_dir)
        fig, ax = plt.subplots(figsize=(10, 8))
        viz.visualize_network_state(t, edge_property=prop, ax=ax)
        st.pyplot(fig)
    if link_keys:
        viz2 = NetworkVisualizer(simulation_dir=sim_dir)
        st.pyplot(viz2.plot_link_evolution(link_keys))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--sim-dir", required=True)
    parser.add_argument("--video", default=None, help="export video and exit")
    parser.add_argument("--html", default=None,
                        help="export a standalone interactive HTML map and exit "
                             "(no streamlit/folium/browser-driver needed)")
    parser.add_argument("--property", default="density")
    parser.add_argument("--fps", type=int, default=10)
    args, _ = parser.parse_known_args(argv)

    if args.video:
        path = generate_video(args.sim_dir, args.video, args.property, args.fps)
        print(f"wrote {path}")
    elif args.html:
        from ..viz import export_interactive_html

        path = export_interactive_html(simulation_dir=args.sim_dir, out_path=args.html)
        print(f"wrote {path}")
    else:
        run_dashboard(args.sim_dir)


if __name__ == "__main__":
    main()
