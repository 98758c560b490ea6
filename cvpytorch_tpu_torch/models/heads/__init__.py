"""Heads of the port.  Importing it registers them."""
from . import seg_heads  # noqa: F401
