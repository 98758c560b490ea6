"""Datasets of the port.  Importing it registers them."""
from . import cityscapes, mini_imagenet, synthetic  # noqa: F401
