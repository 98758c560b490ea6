"""Datasets of the port.  Importing it registers them."""
from . import synthetic  # noqa: F401
