"""Datasets of the port.  Importing it registers them."""
from . import cityscapes, synthetic  # noqa: F401
