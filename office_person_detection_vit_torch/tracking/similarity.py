"""Similarity and cost matrices of online tracking, host numpy.

Mirrors ``office_person_detection_vit_tpu/tracking/similarity.py``: cosine
similarity and distance of L2-normalised features, IoU and IoU distance,
the weighted appearance + motion cost, and position distances, each one
matmul or broadcast. The matrices are small (tracks x detections) and feed
the cascade's host loop, so they stay on the host.
"""

from __future__ import annotations

import numpy as np

from ..ops.boxes import iou_matrix_xywh_np


class SimilarityCalculator:
    def __init__(self, appearance_weight: float = 0.9, motion_weight: float = 0.1):
        if abs(appearance_weight + motion_weight - 1.0) > 1e-6:
            raise ValueError("appearance_weight + motion_weight must sum to 1.0")
        self.appearance_weight = float(appearance_weight)
        self.motion_weight = float(motion_weight)

    @staticmethod
    def cosine_similarity_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """(N, D) x (M, D) L2-normalised features -> (N, M) cosine similarity."""
        if len(a) == 0 or len(b) == 0:
            return np.zeros((len(a), len(b)), np.float32)
        sim = np.asarray(a, np.float32) @ np.asarray(b, np.float32).T
        return np.clip(sim, -1.0, 1.0)

    @classmethod
    def cosine_distance_matrix(cls, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        return 1.0 - cls.cosine_similarity_matrix(a, b)

    @staticmethod
    def iou_matrix(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
        """(N, 4) x (M, 4) xywh -> (N, M) IoU (``ops.boxes.iou_matrix_xywh_np``,
        which the MOT metrics use too)."""
        if len(boxes_a) == 0 or len(boxes_b) == 0:
            return np.zeros((len(boxes_a), len(boxes_b)), np.float32)
        return iou_matrix_xywh_np(boxes_a, boxes_b)

    @classmethod
    def iou_distance_matrix(cls, boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
        return 1.0 - cls.iou_matrix(boxes_a, boxes_b)

    def combined_cost_matrix(self, track_features: np.ndarray, det_features: np.ndarray, track_boxes: np.ndarray,
                             det_boxes: np.ndarray) -> np.ndarray:
        """appearance_weight * cosine distance + motion_weight * IoU distance."""
        app = self.cosine_distance_matrix(track_features, det_features)
        iou = self.iou_distance_matrix(track_boxes, det_boxes)
        return self.appearance_weight * app + self.motion_weight * iou

    @staticmethod
    def position_distance_matrix(pos_a: np.ndarray, pos_b: np.ndarray) -> np.ndarray:
        """(N, 2) x (M, 2) Euclidean distances."""
        if len(pos_a) == 0 or len(pos_b) == 0:
            return np.zeros((len(pos_a), len(pos_b)), np.float32)
        d = np.asarray(pos_a, np.float32)[:, None, :] - np.asarray(pos_b, np.float32)[None, :, :]
        return np.linalg.norm(d, axis=-1).astype(np.float32)
