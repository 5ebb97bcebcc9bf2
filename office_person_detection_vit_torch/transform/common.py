"""What every transformer facade and the transform phase share: one device
pass from foot points to floor coordinates (and zones), written onto the
detections."""

from __future__ import annotations

import numpy as np
import torch

from ..core.dto import Detection
from ..ops.geometry import px_to_mm
from .floormap_config import FloorMapConfig


def apply_floor_transform(transformer, dets: list[Detection], floormap: FloorMapConfig | None = None,
                          zone_classifier=None) -> list[Detection]:
    """foot points -> floor pixels -> millimetres (-> zone membership) in one
    device pass and one copy back, written onto the detections: the one
    definition for homography, PWA, TPS and the transform phase.
    ``floormap`` defaults to the transformer's; ``zone_ids`` is written only
    where a ``ZoneClassifier`` is given."""
    if not dets:
        return dets
    floormap = floormap or transformer.floormap
    device = transformer.device
    feet = torch.tensor(np.asarray([d.foot_point for d in dets], np.float32), device=device)
    floor_px = transformer.transform_tensor(feet)
    origin, mm_per_px = (torch.from_numpy(a).to(device) for a in (floormap.origin_px, floormap.mm_per_px))
    parts = [floor_px, px_to_mm(floor_px, origin, mm_per_px)]
    if zone_classifier is not None:
        parts.append(zone_classifier.zone_mask(floor_px).to(torch.float32))
    host = torch.cat(parts, dim=1).cpu().numpy()
    zone_lists = zone_classifier.zone_lists(host[:, 4:] > 0.5) if zone_classifier is not None else None
    for i, (det, row) in enumerate(zip(dets, host)):
        det.floor_coords_px = (float(row[0]), float(row[1]))
        det.floor_coords_mm = (float(row[2]), float(row[3]))
        if zone_lists is not None:
            det.zone_ids = list(zone_lists[i])
    return dets
