"""Label assigners of the port: DSL (NanoDet-Plus), ATSS (NanoDet v1,
YOLOv6's warm-up epochs) and TAL (YOLOv6)."""
from . import atss_assigner, dsl_assigner, tal_assigner  # noqa: F401
