"""Losses of the port.  Importing it registers them."""
from . import yolov5_loss  # noqa: F401
