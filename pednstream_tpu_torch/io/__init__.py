from .output_handler import OutputHandler

__all__ = ["OutputHandler"]
