"""Zone classification facade: the implementation is ``ops/zones.py``,
re-exported under the JAX package's module layout
(``office_person_detection_vit_tpu/zone/zone_classifier.py``)."""

from ..ops.zones import PackedZones, ZoneClassifier, classify_priority, points_in_zones

__all__ = ["PackedZones", "ZoneClassifier", "classify_priority", "points_in_zones"]
