"""Runtime configuration of the port (serve knobs)."""
from .config import Config  # noqa: F401
