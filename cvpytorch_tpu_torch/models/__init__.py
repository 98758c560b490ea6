"""Model zoo of the port.  Importing it registers the models."""
from . import (  # noqa: F401
    airdet, classification, efficientdet, fcos, giraffedet, keypoint, lfd, light_seg, light_seg2,
    light_seg3, nanodet_plus, objectbox, rcnn, retinanet, segmentor, segnet_enet, unet, yolop,
    yolov5, yolov6, yolov7, yolox)
