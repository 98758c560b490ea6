"""Losses of the port.  Importing it registers them."""
from . import objectbox_loss, seg_loss, yolov5_loss, yolov7_loss  # noqa: F401
