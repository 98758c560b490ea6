"""Datasets of the port.  Importing it registers them."""
from . import cityscapes, coco, mini_imagenet, synthetic  # noqa: F401
