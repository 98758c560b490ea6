"""Necks of the port.  Importing it registers them."""
from . import (  # noqa: F401
    asff, fcos_fpn, ghost_pan, giraffe_neck, nas_fpn, pan, rfp, tan, yolov5_neck)
