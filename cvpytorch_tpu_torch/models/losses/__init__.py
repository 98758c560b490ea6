"""Losses of the port.  Importing it registers them."""
from . import seg_loss, yolov5_loss  # noqa: F401
