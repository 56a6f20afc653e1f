from .ctrl import parse_control_file
from .vtu import write_vtu

__all__ = ["parse_control_file", "write_vtu"]
