"""Label assigners of the port: DSL (NanoDet-Plus), ATSS (NanoDet v1,
YOLOv6's warm-up epochs), TAL (YOLOv6) and SimOTA (YOLOX)."""
from . import atss_assigner, dsl_assigner, ota_assigner, tal_assigner  # noqa: F401
