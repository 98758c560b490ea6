"""Model zoo of the port.  Importing it registers the models."""
from . import (  # noqa: F401
    classification, fcos, lfd, light_seg, light_seg2, light_seg3, nanodet_plus, rcnn,
    retinanet, segmentor, segnet_enet, unet, yolov5, yolov6, yolov7, yolox)
