"""Anchor generators of the port (counterpart of
``cvpytorch_tpu/models/anchors/``): the standalone SSD prior boxes; the
other models keep their anchors beside them."""
from .prior_box import PriorBox, ssd_prior_boxes  # noqa: F401
