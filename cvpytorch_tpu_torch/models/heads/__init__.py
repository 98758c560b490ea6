"""Heads of the port.  Importing it registers them."""
from . import fcos_head, gflv2_head, nanodet_head, seg_heads, seg_heads_extra  # noqa: F401
