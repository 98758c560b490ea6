"""Necks of the port.  Importing it registers them."""
from . import asff, fcos_fpn, ghost_pan, pan, tan, yolov5_neck  # noqa: F401
