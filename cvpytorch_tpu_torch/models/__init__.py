"""Model zoo of the port.  Importing it registers the models."""
from . import classification, nanodet_plus, rcnn, segmentor, unet, yolov5  # noqa: F401
