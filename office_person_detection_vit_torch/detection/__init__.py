"""detection of the PyTorch port: the DETR, single-shot and YOLOv8 detectors."""

from .detector import DETRDetector
from .ssd_detector import SSDDetector, build_detector
from .yolo_detector import YOLODetector

__all__ = ["DETRDetector", "SSDDetector", "YOLODetector", "build_detector"]
