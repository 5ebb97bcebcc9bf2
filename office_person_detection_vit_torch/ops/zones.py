"""Point-in-polygon zone classification on tensors.

Mirrors ``office_person_detection_vit_tpu/ops/zones.py``: ``PackedZones``
(polygons padded to one vertex count), the even-odd ray cast
``points_in_zones`` over (points x zones x edges), ``classify_priority`` and
the facade ``ZoneClassifier`` (which ``zone/zone_classifier.py`` re-exports),
whose :meth:`ZoneClassifier.zone_mask` also takes a tensor already on the
device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device


@dataclass(frozen=True)
class PackedZones:
    """vertices (Z, V, 2) float32 padded by repeating the last vertex;
    num_vertices (Z,) int32; priorities (Z,) int32 (lower wins); ids, names."""

    vertices: np.ndarray
    num_vertices: np.ndarray
    priorities: np.ndarray
    ids: tuple[str, ...]
    names: tuple[str, ...]

    @classmethod
    def from_config(cls, zones: list[dict]) -> "PackedZones":
        if not zones:
            return cls(np.zeros((0, 3, 2), np.float32), np.zeros((0,), np.int32),
                       np.zeros((0,), np.int32), (), ())
        max_v = max(len(z["polygon"]) for z in zones)
        Z = len(zones)
        verts = np.zeros((Z, max_v, 2), np.float32)
        nv = np.zeros((Z,), np.int32)
        prio = np.zeros((Z,), np.int32)
        ids, names = [], []
        for i, z in enumerate(zones):
            poly = np.asarray(z["polygon"], np.float32)
            if poly.ndim != 2 or poly.shape[0] < 3 or poly.shape[1] != 2:
                raise ValueError(f"zone {z.get('id')}: polygon must be (>=3, 2)")
            verts[i, : len(poly)] = poly
            verts[i, len(poly):] = poly[-1]
            nv[i] = len(poly)
            prio[i] = int(z.get("priority", i + 1))
            ids.append(str(z.get("id", f"zone_{i}")))
            names.append(str(z.get("name", ids[-1])))
        return cls(verts, nv, prio, tuple(ids), tuple(names))


def points_in_zones(points: torch.Tensor, vertices: torch.Tensor,
                    num_vertices: torch.Tensor) -> torch.Tensor:
    """Even-odd ray cast to +x: points (N, 2), vertices (Z, V, 2) -> (N, Z) bool.
    Edge i joins vertex i to vertex i+1 (wrapping at the real count); padded
    edges are masked out."""
    Z, V, _ = vertices.shape
    px = points[:, None, None, 0]
    py = points[:, None, None, 1]
    idx = torch.arange(V, device=vertices.device)
    next_idx = torch.where(idx[None, :] + 1 >= num_vertices[:, None], 0, idx[None, :] + 1)
    v1 = torch.gather(vertices, 1, next_idx[:, :, None].expand(Z, V, 2).long())[None]
    v0 = vertices[None]
    x0, y0 = v0[..., 0], v0[..., 1]
    x1, y1 = v1[..., 0], v1[..., 1]
    edge_valid = (idx[None, :] < num_vertices[:, None])[None]
    cond = (y0 > py) != (y1 > py)
    denom = y1 - y0
    safe_denom = torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12), denom)
    x_int = x0 + (py - y0) * (x1 - x0) / safe_denom
    crossing = cond & (px < x_int) & edge_valid
    return (crossing.sum(dim=-1) % 2) == 1


def classify_priority(membership: torch.Tensor, priorities: torch.Tensor) -> torch.Tensor:
    """(N, Z) bool, (Z,) int -> (N,) int64 index of the member zone with the
    smallest priority, or -1 for none."""
    if membership.shape[-1] == 0:
        return torch.full(membership.shape[:-1], -1, dtype=torch.int64, device=membership.device)
    eff = torch.where(membership, priorities[None, :].to(torch.int64), 2**30)
    best = torch.argmin(eff, dim=-1)
    return torch.where(membership.any(dim=-1), best, -1)


class ZoneClassifier:
    """Host facade: ``overlap_mode="all"`` counts a point in every zone it is
    in; ``"priority"`` keeps only the zone of smallest priority.

    ``device`` takes the values of ``detection.device`` (see
    :func:`~office_person_detection_vit_torch.device.resolve_device`): the
    default ``"auto"`` is the card, and raises where there is none; ``"cpu"``
    runs on the CPU."""

    def __init__(self, zones: list[dict], overlap_mode: str = "all",
                 device: torch.device | str = "auto"):
        self._validate(zones)
        self.packed = PackedZones.from_config(zones)
        self.overlap_mode = overlap_mode
        self.device = resolve_device(str(device))
        self._vertices = torch.from_numpy(self.packed.vertices).to(self.device)
        self._num_vertices = torch.from_numpy(self.packed.num_vertices).to(self.device)
        self._priorities = torch.from_numpy(self.packed.priorities).to(self.device)

    @staticmethod
    def _validate(zones: list[dict]) -> None:
        seen = set()
        for z in zones:
            zid = z.get("id")
            if zid is None:
                raise ValueError("zone missing id")
            if zid in seen:
                raise ValueError(f"duplicate zone id {zid}")
            seen.add(zid)
            if len(z.get("polygon", [])) < 3:
                raise ValueError(f"zone {zid}: polygon needs >= 3 vertices")

    @property
    def zone_ids(self) -> tuple[str, ...]:
        return self.packed.ids

    def _membership(self, points) -> torch.Tensor:
        """(N, 2) points (host array, or a tensor on any device) -> (N, Z)
        bool membership on this classifier's device."""
        if isinstance(points, torch.Tensor):
            pts = points.to(self.device, torch.float32).reshape(-1, 2)
        else:
            pts = torch.tensor(np.atleast_2d(np.asarray(points, np.float32)), device=self.device)
        if self._vertices.shape[0] == 0:
            return torch.zeros((pts.shape[0], 0), dtype=torch.bool, device=self.device)
        return points_in_zones(pts, self._vertices, self._num_vertices)

    def membership(self, points) -> np.ndarray:
        """(N, 2) -> (N, Z) bool membership matrix (host numpy)."""
        return self._membership(points).cpu().numpy()

    def zone_mask(self, points) -> torch.Tensor:
        """(N, 2) -> (N, Z) bool on the device: the zones each point is
        counted in under the overlap mode (every zone it is in, or only the
        one of smallest priority)."""
        m = self._membership(points)
        if self.overlap_mode == "all" or m.shape[-1] == 0:
            return m
        best = classify_priority(m, self._priorities)
        zones = torch.arange(m.shape[-1], device=m.device)
        return best[:, None] == zones[None, :]

    def zone_lists(self, mask: np.ndarray) -> list[list[str]]:
        """A host (N, Z) :meth:`zone_mask` -> each point's zone ids."""
        return [[self.packed.ids[z] for z in np.nonzero(row)[0]] for row in mask]

    def classify(self, point: tuple[float, float]) -> list[str]:
        return self.classify_batch(np.asarray([point], np.float32))[0]

    def classify_batch(self, points) -> list[list[str]]:
        return self.zone_lists(self.zone_mask(points).cpu().numpy())

    def classify_with_unclassified(self, points) -> list[list[str]]:
        return [zs if zs else ["unclassified"] for zs in self.classify_batch(points)]
