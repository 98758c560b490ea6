"""Datasets of the port.  Importing it registers them."""
from . import cityscapes, coco, mini_imagenet, misc_datasets, synthetic, voc  # noqa: F401
