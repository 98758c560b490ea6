"""Model zoo of the port.  Importing it registers the models."""
from . import rcnn, segmentor, unet, yolov5  # noqa: F401
