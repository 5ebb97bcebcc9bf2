"""Configuration management: YAML/JSON load, dot-path access, validation.

The port's own copy of ``office_person_detection_vit_tpu/config/config_manager.py``
(reference src/config/config_manager.py:14-587): load YAML or JSON, dot-path
``get``/``set``, hard validation of required keys and types per section,
defaults for every section, auto-backfill of missing sections, and save-back.
The keys, defaults and validation are the JAX package's. ``detection.device``
takes ``auto``/``cuda`` (the card; the run raises when there is none, see
``device.py``) or ``cpu``. :meth:`ConfigManager.static_hparams` freezes the
values that fix the detector's shapes into a hashable dataclass, as in JAX.
"""

from __future__ import annotations

import copy
import json
import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import yaml

logger = logging.getLogger(__name__)


class ConfigValidationError(ValueError):
    """Raised when the configuration fails validation."""


#: Required keys per section. A key maps to the type(s) it must have.
REQUIRED_KEYS: dict[str, dict[str, type | tuple[type, ...]]] = {
    "video": {
        "input_path": str,
        "fps": (int, float),
        "frame_interval_minutes": (int, float),
        "tolerance_seconds": (int, float),
        "time_compression_ratio": (int, float),
    },
    "detection": {
        "confidence_threshold": (int, float),
        "batch_size": int,
        "device": str,
    },
    "output": {
        "directory": str,
    },
}

#: Defaults for every section (merged under user config).
DEFAULT_CONFIG: dict[str, Any] = {
    "video": {
        "input_path": "input/video.mov",
        "is_timelapse": True,
        "frame_interval_minutes": 5,
        "tolerance_seconds": 30,
        "scan_margin_minutes": 5,
        "fps": 30,
        "time_compression_ratio": 313.0,
        "dense_tracking": {
            "enabled": False,
            "tracking_interval_seconds": 10,
            "output_interval_minutes": 5,
        },
    },
    "detection": {
        # Primary detector: DETR (facebook/detr-resnet-50 architecture).
        "model": "detr",
        "model_name": "facebook/detr-resnet-50",
        "checkpoint_path": None,
        "confidence_threshold": 0.5,
        "nms_threshold": 0.4,
        "iou_threshold": 0.45,
        # "auto" and "cuda" mean the card, and raise when there is none
        # (device.py); "cpu" runs on the CPU.
        "device": "auto",
        "batch_size": 4,
        "num_queries": 100,
        # Static input shape of the preprocessing and the model.
        "input_height": 736,
        "input_width": 1280,
        "dtype": "bfloat16",
        "use_pallas_attention": False,  # read and ignored: on the card attention always runs the CUDA kernels
        # full | tiny (tests / dry runs)
        "model_size": "full",
        # DETR-DC5: stride-16 dilated last backbone stage (small objects)
        "dilate_c5": False,
        # bgr | i420 (i420 halves host->device bytes; costs a host cvtColor)
        "transfer_format": "bgr",
        # rematerialize transformer layers under grad (training memory)
        "remat": False,
    },
    "tracking": {
        "enabled": False,
        "algorithm": "deepsort",
        "max_age": 100,
        "min_hits": 1,
        "iou_threshold": 0.5,
        "appearance_weight": 0.9,
        "motion_weight": 0.1,
        "max_position_distance": 10000.0,
        "hybrid_mode": {"enabled": False, "use_optical_flow": True},
        "reid": {"enabled": False, "model_type": "osnet", "model_name": None, "model_path": None},
    },
    "transform": {
        "method": "homography",
        "model_path": None,
        "lens_distortion": {
            "enabled": False,
            "k1": 0.0, "k2": 0.0, "k3": 0.0, "p1": 0.0, "p2": 0.0,
            "focal_length_x": 1250.0, "focal_length_y": 1250.0,
            "center_x": 640.0, "center_y": 360.0,
            "image_width": 1280, "image_height": 720,
        },
    },
    "homography": {"matrix": None},
    "camera_params": {
        "height_m": 2.2, "pitch_deg": 12.0, "yaw_deg": 20.0, "roll_deg": 0.0,
        "camera_x_m": 0.0, "camera_y_m": 0.0,
        "position_x_px": 859.0, "position_y_px": 1040.0,
        "focal_length_x": 1250.0, "focal_length_y": 1250.0,
        "center_x": 640.0, "center_y": 360.0,
        "image_width": 1280, "image_height": 720,
        "dist_coeffs": [0.0, 0.0, 0.0, 0.0, 0.0],
    },
    "camera": {
        "position_x": 859, "position_y": 1040, "height_m": 2.2,
        "show_on_floormap": True, "marker_color": [0, 0, 255], "marker_size": 15,
    },
    "calibration": {
        "mode": "hybrid",
        "correspondence_file": None,
        "use_distortion_correction": False,
        "use_intrinsics": True,
        "reprojection_error_threshold": 10.0,
        "optimization": {"max_iterations": 100, "tolerance": 1.0e-6},
    },
    "floormap": {
        "image_path": "data/floormap.png",
        "image_width": 1878,
        "image_height": 1369,
        "image_origin_x": 7,
        "image_origin_y": 9,
        "image_x_mm_per_pixel": 28.1926406926406,
        "image_y_mm_per_pixel": 28.241430700447,
    },
    "zones": [],
    "output": {
        "directory": "output",
        "use_session_management": True,
        "save_detection_images": False,
        "save_tracking_images": False,
        "save_floormap_images": False,
        "save_side_by_side_video": False,
        "side_by_side_video_fps": 1.0,
        "debug_mode": False,
        "cleanup_temp_files": True,
        "json_optimization": {
            "enabled": False,
            "coordinate_precision": 1,
            "compact_keys": False,
            "exclude_px_coords": False,
        },
        "session": {"archive_days": 30, "delete_archive_days": 90},
    },
    "timestamp": {
        "extraction": {
            "confidence_threshold": 0.5,
            "retry_count": 3,
            "use_improved_validator": True,
            "validator": {
                "base_tolerance_seconds": 30.0,
                "history_size": 10,
                "z_score_threshold": 3.0,
            },
            "roi": {
                "x_ratio": 0.70,
                "y_ratio": 0.045,
                "width_ratio": 0.28,
                "height_ratio": 0.06,
            },
        },
        "extraction_mode": "auto_targets",
        "auto_targets": {"max_frames": 290, "disable_validation": True},
        "sampling": {
            "coarse_interval_seconds": 5.0,
            "fine_interval_seconds": 1.0,
            "search_window_seconds": 30.0,
        },
    },
    "ocr": {
        "engines": ["tesseract", "template", "zoning"],
        "tesseract": {"config": "--psm 8 --oem 3", "whitelist": "0123456789/:  "},
        "consensus": "weighted",
    },
    "evaluation": {"ground_truth_path": None, "iou_threshold": 0.5},
    "parallel": {
        # Device-mesh axes for scale-out (SURVEY.md §5.8). On a single chip the
        # mesh degrades to 1x1; on a pod slice the batch is sharded over
        # "data" and the model optionally tensor-sharded over "model".
        "mesh": {"data": -1, "model": 1},
    },
}


def _is_device(value: str) -> bool:
    """Whether ``value`` names a device of the port (``device.resolve_device``)."""
    v = value.strip().lower()
    return v in ("auto", "cuda", "cpu") or (v.startswith("cuda:") and v[5:].isdigit())


def _deep_merge(base: dict, override: dict) -> dict:
    """Recursively merge ``override`` on top of ``base`` (new dict)."""
    out = copy.deepcopy(base)
    for key, value in override.items():
        if key in out and isinstance(out[key], dict) and isinstance(value, dict):
            out[key] = _deep_merge(out[key], value)
        else:
            out[key] = copy.deepcopy(value)
    return out


@dataclass(frozen=True)
class StaticHParams:
    """Hashable view of the config values that fix the detector's shapes."""

    batch_size: int
    num_queries: int
    input_height: int
    input_width: int
    confidence_threshold: float
    dtype: str
    use_pallas_attention: bool

    @classmethod
    def from_config(cls, cfg: "ConfigManager") -> "StaticHParams":
        return cls(
            batch_size=int(cfg.get("detection.batch_size", 4)),
            num_queries=int(cfg.get("detection.num_queries", 100)),
            input_height=int(cfg.get("detection.input_height", 736)),
            input_width=int(cfg.get("detection.input_width", 1280)),
            confidence_threshold=float(cfg.get("detection.confidence_threshold", 0.5)),
            dtype=str(cfg.get("detection.dtype", "bfloat16")),
            use_pallas_attention=bool(cfg.get("detection.use_pallas_attention", False)),
        )


class ConfigManager:
    """Load + validate + access configuration via dot paths.

    >>> cfg = ConfigManager.from_dict({"detection": {"batch_size": 8}})
    >>> cfg.get("detection.batch_size")
    8
    >>> cfg.get("does.not.exist", "fallback")
    'fallback'
    """

    def __init__(self, config_path: str | Path | None = None, *, apply_defaults: bool = True):
        self.config_path = Path(config_path) if config_path else None
        user_cfg: dict[str, Any] = {}
        if self.config_path is not None:
            user_cfg = self._load_file(self.config_path)
        self._config = _deep_merge(DEFAULT_CONFIG, user_cfg) if apply_defaults else user_cfg

    # ------------------------------------------------------------- loading
    @staticmethod
    def _load_file(path: Path) -> dict[str, Any]:
        if not path.exists():
            raise FileNotFoundError(f"config file not found: {path}")
        text = path.read_text(encoding="utf-8")
        if path.suffix in (".yaml", ".yml"):
            data = yaml.safe_load(text)
        elif path.suffix == ".json":
            data = json.loads(text)
        else:
            raise ConfigValidationError(f"unsupported config format: {path.suffix}")
        if data is None:
            data = {}
        if not isinstance(data, dict):
            raise ConfigValidationError("top-level config must be a mapping")
        return data

    @classmethod
    def from_dict(cls, data: dict[str, Any], *, apply_defaults: bool = True) -> "ConfigManager":
        self = cls.__new__(cls)
        self.config_path = None
        self._config = _deep_merge(DEFAULT_CONFIG, data) if apply_defaults else copy.deepcopy(data)
        return self

    # -------------------------------------------------------------- access
    def get(self, dot_path: str, default: Any = None) -> Any:
        node: Any = self._config
        for part in dot_path.split("."):
            if isinstance(node, dict) and part in node:
                node = node[part]
            else:
                return default
        return node

    def set(self, dot_path: str, value: Any) -> None:
        parts = dot_path.split(".")
        node = self._config
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], dict):
                node[part] = {}
            node = node[part]
        node[parts[-1]] = value

    def as_dict(self) -> dict[str, Any]:
        return copy.deepcopy(self._config)

    def static_hparams(self) -> StaticHParams:
        return StaticHParams.from_config(self)

    # ---------------------------------------------------------- validation
    def validate(self) -> bool:
        """Validate required keys/types. Raises ConfigValidationError on failure."""
        errors: list[str] = []
        for section, keys in REQUIRED_KEYS.items():
            sec = self._config.get(section)
            if not isinstance(sec, dict):
                errors.append(f"missing required section: {section}")
                continue
            for key, typ in keys.items():
                if key not in sec:
                    errors.append(f"missing required key: {section}.{key}")
                elif not isinstance(sec[key], typ):
                    errors.append(
                        f"bad type for {section}.{key}: expected {typ}, got {type(sec[key]).__name__}"
                    )
        errors.extend(self._validate_ranges())
        errors.extend(self._validate_zones())
        if errors:
            raise ConfigValidationError("; ".join(errors))
        return True

    def _validate_ranges(self) -> list[str]:
        errors: list[str] = []

        # detection.* non-numeric values are reported by the REQUIRED_KEYS
        # type check; keys outside REQUIRED_KEYS (tracking.*) must report a
        # bad-type error here or a string weight would silently pass
        # validation and crash mid-run instead.
        def _num(dot_path: str, *, typed_elsewhere: bool) -> float | None:
            v = self.get(dot_path)
            if v is None:
                return None
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                return float(v)
            if not typed_elsewhere:
                errors.append(
                    f"bad type for {dot_path}: expected number, got {type(v).__name__}"
                )
            return None

        conf = _num("detection.confidence_threshold", typed_elsewhere=True)
        if conf is not None and not (0.0 <= conf <= 1.0):
            errors.append("detection.confidence_threshold must be in [0, 1]")
        bs = _num("detection.batch_size", typed_elsewhere=True)
        if bs is not None and bs < 1:
            errors.append("detection.batch_size must be >= 1")
        aw = _num("tracking.appearance_weight", typed_elsewhere=False)
        mw = _num("tracking.motion_weight", typed_elsewhere=False)
        if aw is not None and mw is not None and abs(aw + mw - 1.0) > 1e-6:
            errors.append("tracking.appearance_weight + motion_weight must sum to 1.0")
        # Calibration section checks (reference config_manager.py:460-472).
        for flag in ("calibration.use_distortion_correction", "calibration.use_intrinsics"):
            v = self.get(flag)
            if v is not None and not isinstance(v, bool):
                errors.append(f"{flag} must be a boolean")
        thr = _num("calibration.reprojection_error_threshold", typed_elsewhere=False)
        if thr is not None and thr <= 0:
            errors.append("calibration.reprojection_error_threshold must be > 0")
        device = self.get("detection.device")
        if isinstance(device, str) and not _is_device(device):
            errors.append(f"detection.device must be auto, cuda, cuda:N or cpu, got {device!r}")
        method = self.get("transform.method")
        if method not in (None, "homography", "piecewise_affine", "thin_plate_spline"):
            errors.append(f"unknown transform.method: {method}")
        return errors

    def _validate_zones(self) -> list[str]:
        errors = []
        zones = self.get("zones", [])
        seen: set[str] = set()
        for z in zones or []:
            zid = z.get("id")
            if zid is None:
                errors.append("zone missing id")
                continue
            if zid in seen:
                errors.append(f"duplicate zone id: {zid}")
            seen.add(zid)
            poly = z.get("polygon", [])
            if len(poly) < 3:
                errors.append(f"zone {zid} polygon needs >= 3 vertices")
        return errors

    # --------------------------------------------------------------- save
    def save(self, path: str | Path | None = None) -> Path:
        target = Path(path) if path else self.config_path
        if target is None:
            raise ValueError("no path to save config to")
        target.parent.mkdir(parents=True, exist_ok=True)
        if target.suffix == ".json":
            target.write_text(json.dumps(self._config, indent=2, ensure_ascii=False), encoding="utf-8")
        else:
            target.write_text(
                yaml.safe_dump(self._config, allow_unicode=True, sort_keys=False), encoding="utf-8"
            )
        return target
