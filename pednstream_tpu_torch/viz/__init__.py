from .html_export import export_interactive_html
from .visualizer import NetworkVisualizer, progress_callback

__all__ = ["NetworkVisualizer", "progress_callback", "export_interactive_html"]
