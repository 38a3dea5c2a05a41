from .server import SimulationManager, build_server, TOOLS

__all__ = ["SimulationManager", "build_server", "TOOLS"]
