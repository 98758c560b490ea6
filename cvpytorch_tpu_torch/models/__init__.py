"""Model zoo of the port.  Importing it registers the models."""
from . import rcnn, yolov5  # noqa: F401
