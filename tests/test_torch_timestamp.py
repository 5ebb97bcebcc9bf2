"""Phase 1 of the port against the JAX package's, on the CPU: the host
modules it runs, each fed the same inputs as its JAX counterpart.

- ``timestamp/``: ``TimestampParser`` (the same datetimes), ``TemporalValidatorV2``
  (the same verdicts), the string scores of ``ocr_engine``, the template and
  zoning engines and ``MultiEngineOCR`` in each consensus mode (the same
  strings, confidences within 1e-6) on rendered ROI crops, some with noise,
  the bitmap font, and ``TimestampExtractorV2`` (the same results and cache
  statistics over a frame sequence, one frame at a time and in batches).
- ``video/``: the samplers give the same indices; ``VideoProcessor`` the
  same frames, byte for byte, from a synthetic video; ``PrefetchLoader`` the
  same batches.
- ``pipeline/frame_extraction_pipeline.py`` in ``manual_targets`` mode: the
  same ``extraction_results.csv`` and the same saved frames (the whole flow
  of ``tests/test_torch_pipeline.py`` holds the ``auto_targets`` mode so).
"""

import csv
from datetime import datetime, timedelta
from pathlib import Path

import numpy as np
import pytest

from office_person_detection_vit_torch.config.config_manager import ConfigManager
from office_person_detection_vit_torch.pipeline.frame_extraction_pipeline import FrameExtractionPipeline
from office_person_detection_vit_torch.timestamp import bitmap_font, ocr_engine, template_ocr, zoning_ocr
from office_person_detection_vit_torch.timestamp.roi_extractor import TimestampROIExtractor
from office_person_detection_vit_torch.timestamp.timestamp_extractor import TimestampExtractorV2
from office_person_detection_vit_torch.timestamp.timestamp_parser import TimestampParser
from office_person_detection_vit_torch.timestamp.timestamp_validator import TemporalValidatorV2
from office_person_detection_vit_torch.video import frame_sampler
from office_person_detection_vit_torch.video.prefetch import PrefetchLoader, prefetch_iter
from office_person_detection_vit_torch.video.video_processor import VideoProcessor
from office_person_detection_vit_tpu.config.config_manager import ConfigManager as JaxConfigManager
from office_person_detection_vit_tpu.pipeline.frame_extraction_pipeline import (
    FrameExtractionPipeline as JaxFrameExtractionPipeline,
)
from office_person_detection_vit_tpu.timestamp import bitmap_font as jax_bitmap_font
from office_person_detection_vit_tpu.timestamp import ocr_engine as jax_ocr_engine
from office_person_detection_vit_tpu.timestamp import template_ocr as jax_template_ocr
from office_person_detection_vit_tpu.timestamp import zoning_ocr as jax_zoning_ocr
from office_person_detection_vit_tpu.timestamp.roi_extractor import TimestampROIExtractor as JaxROIExtractor
from office_person_detection_vit_tpu.timestamp.timestamp_extractor import TimestampExtractorV2 as JaxExtractor
from office_person_detection_vit_tpu.timestamp.timestamp_parser import TimestampParser as JaxParser
from office_person_detection_vit_tpu.timestamp.timestamp_validator import TemporalValidatorV2 as JaxValidator
from office_person_detection_vit_tpu.video import frame_sampler as jax_frame_sampler
from office_person_detection_vit_tpu.video.prefetch import PrefetchLoader as JaxPrefetchLoader
from office_person_detection_vit_tpu.video.prefetch import prefetch_iter as jax_prefetch_iter
from office_person_detection_vit_tpu.video.video_processor import VideoProcessor as JaxVideoProcessor
from tests.helpers.synthetic_video import render_frame, write_video
from tests.helpers.torch_threads import two_torch_threads  # noqa: F401 (autouse: 2 torch threads)

T0 = datetime(2025, 1, 20, 9, 0, 0)
CONF_TOL = 1e-6


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    # 100 frames at 30 fps, ratio 313: 09:00:00 to 09:17:12, four 5-minute targets
    return write_video(tmp_path_factory.mktemp("video") / "synthetic.mp4", num_frames=100)


# ------------------------------------------------------------------ parser
PARSE_TEXTS = ["2025/01/20 09:05:13", "2025-01-20 09:05", "2025年01月20日 09時05分13秒", "20250120 090513",
               "2025/01/20 0905", "2025/0120 09:05:13", "2025//01/20 09::05:13", "2025/01/20 09 05 13",
               "2O25/0l/2O O9:O5:l3", "2025/13/40 25:61:61", "garbage", ""]


@pytest.mark.parametrize("text", PARSE_TEXTS)
def test_timestamp_parser_matches_jax(text):
    port, ref = TimestampParser(), JaxParser()
    assert port.parse(text) == ref.parse(text)
    assert port.fuzzy_parse(text) == ref.fuzzy_parse(text)


# --------------------------------------------------------------- validator
def _validator_sequence():
    """(frame, timestamp) in scan order at ratio 313: steady steps, a misread
    digit, a backwards read, a repeated frame and a slow drift."""
    step = timedelta(seconds=6 / 30 * 313)
    seq = [(6 * i, T0 + i * step) for i in range(6)]
    seq += [(36, T0 + timedelta(hours=1)), (42, T0 + 7 * step), (42, T0 + 7 * step), (48, T0 + 3 * step)]
    seq += [(54 + 6 * i, T0 + (9 + i) * step + timedelta(seconds=9 * i)) for i in range(6)]
    return seq


@pytest.mark.parametrize("kwargs", [{}, {"base_tolerance_seconds": 5.0, "history_size": 4, "z_score_threshold": 1.5}],
                         ids=["defaults", "tight"])
def test_temporal_validator_matches_jax(kwargs):
    port, ref = (cls(fps=30.0, time_compression_ratio=313.0, **kwargs) for cls in (TemporalValidatorV2, JaxValidator))
    verdicts = []
    for fn, ts in _validator_sequence():
        got, want = port.validate(ts, fn, 0.9), ref.validate(ts, fn, 0.9)
        assert (got.is_valid, got.timestamp, got.reason, got.corrected) == (
            want.is_valid, want.timestamp, want.reason, want.corrected)
        assert got.confidence == pytest.approx(want.confidence, abs=CONF_TOL)
        verdicts.append((got.is_valid, got.corrected))
    assert (False, False) in verdicts and (True, True) in verdicts  # a rejection and a recovery


# --------------------------------------------------------------------- OCR
@pytest.mark.parametrize("pair", [("2025/01/20 09:05:13", "2025/01/20 09:05:13"), ("2025/01/20 09:05:13", "2O25/01/20"),
                                  ("", "abc"), ("12:00", "1200")])
def test_string_scores_match_jax(pair):
    a, b = pair
    assert ocr_engine.levenshtein(a, b) == jax_ocr_engine.levenshtein(a, b)
    assert ocr_engine.similarity(a, b) == jax_ocr_engine.similarity(a, b)
    for s in pair:
        assert ocr_engine.format_confidence(s) == jax_ocr_engine.format_confidence(s)


def _roi_crops():
    """Preprocessed timestamp ROIs of rendered frames: clean, with Gaussian
    noise, and in the Hershey duplex face."""
    roi = TimestampROIExtractor()
    crops = []
    for i, (noise, font) in enumerate([(0, "FONT_HERSHEY_SIMPLEX"), (0, "FONT_HERSHEY_SIMPLEX"), (18, "FONT_HERSHEY_SIMPLEX"),
                                       (40, "FONT_HERSHEY_SIMPLEX"), (0, "FONT_HERSHEY_DUPLEX")]):
        frame = render_frame(T0 + timedelta(minutes=37 * i, seconds=11 * i), seed=i, font=font)
        if noise:
            frame = np.clip(frame + np.random.default_rng(i).normal(0, noise, frame.shape), 0, 255).astype(np.uint8)
        crops.append(roi.preprocess_roi(roi.extract_roi(frame)))
    return crops


CROP_IDS = ["clean", "clean_2", "noise_18", "noise_40", "duplex"]


@pytest.fixture(scope="module")
def crops():
    return _roi_crops()


def test_roi_extractor_matches_jax():
    frame = render_frame(T0, seed=3)
    port, ref = TimestampROIExtractor(), JaxROIExtractor()
    assert np.array_equal(port.extract_roi(frame), ref.extract_roi(frame))
    assert np.array_equal(port.preprocess_roi(port.extract_roi(frame)), ref.preprocess_roi(ref.extract_roi(frame)))


@pytest.mark.parametrize("engine", ["template", "zoning"])
@pytest.mark.parametrize("crop", range(5), ids=CROP_IDS)
def test_ocr_engine_matches_jax(crops, engine, crop):
    mods = {"template": (template_ocr.TemplateOCREngine, jax_template_ocr.TemplateOCREngine),
            "zoning": (zoning_ocr.ZoningOCREngine, jax_zoning_ocr.ZoningOCREngine)}[engine]
    (text, conf), (want_text, want_conf) = (cls().extract(crops[crop]) for cls in mods)
    assert text == want_text
    assert conf == pytest.approx(want_conf, abs=CONF_TOL)
    if crop == 0:
        assert TimestampParser().fuzzy_parse(text) == T0  # the clean crop reads right


@pytest.mark.parametrize("consensus", ["weighted", "baseline", "voting"])
def test_multi_engine_ocr_matches_jax(crops, consensus):
    """The default engine list (tesseract where installed, template,
    zoning), and the engines that are missing fall back as in JAX."""
    port, ref = ocr_engine.MultiEngineOCR(consensus=consensus), jax_ocr_engine.MultiEngineOCR(consensus=consensus)
    assert [e.name for e in port.engines] == [e.name for e in ref.engines]
    for crop in crops:
        (text, conf), (want_text, want_conf) = port.extract_with_consensus(crop), ref.extract_with_consensus(crop)
        assert text == want_text
        assert conf == pytest.approx(want_conf, abs=CONF_TOL)


def test_multi_engine_ocr_falls_back_to_template_like_jax():
    port = ocr_engine.MultiEngineOCR(engines=["easyocr", "nonexistent"])
    ref = jax_ocr_engine.MultiEngineOCR(engines=["easyocr", "nonexistent"])
    assert [e.name for e in port.engines] == [e.name for e in ref.engines] == ["template"]


@pytest.mark.parametrize("scale", [2, 3])
def test_bitmap_font_matches_jax(scale):
    text = "2025/01/20 09:05:13"
    assert np.array_equal(bitmap_font.render_text(text, scale=scale), jax_bitmap_font.render_text(text, scale=scale))


# --------------------------------------------------------------- extractor
def _extractor_config(module, validation: bool):
    return module.from_dict({"timestamp": {"auto_targets": {"disable_validation": not validation},
                                           "extraction": {"confidence_threshold": 0.3}}})


@pytest.mark.parametrize("validation", [False, True], ids=["no_validator", "validator"])
def test_timestamp_extractor_matches_jax(validation):
    step = timedelta(seconds=6 / 30 * 313)
    frames = [render_frame(T0 + i * step, people=[(300 + 9 * i, 300, i % 6)], seed=i) for i in range(6)]
    frames.append(frames[2].copy())  # a repeat: a cache hit
    frames.append(np.full_like(frames[0], 40))  # no text
    port = TimestampExtractorV2.from_config(_extractor_config(ConfigManager, validation))
    ref = JaxExtractor.from_config(_extractor_config(JaxConfigManager, validation))
    for i, frame in enumerate(frames[:4]):
        (ts, conf), (want_ts, want_conf) = port.extract(frame, 6 * i), ref.extract(frame, 6 * i)
        assert ts == want_ts and conf == pytest.approx(want_conf, abs=CONF_TOL)
    batch = [(6 * (4 + i), f) for i, f in enumerate(frames[4:])]
    got, want = port.extract_batch_parallel(batch), ref.extract_batch_parallel(batch)
    assert [(fn, ts) for fn, ts, _ in got] == [(fn, ts) for fn, ts, _ in want]
    np.testing.assert_allclose([c for *_, c in got], [c for *_, c in want], rtol=0, atol=CONF_TOL)
    assert port.get_cache_stats() == ref.get_cache_stats()
    assert port.get_cache_stats()["hits"] >= 1 and got[-1][1] is None


# ------------------------------------------------------------------- video
@pytest.mark.parametrize("args", [(0.19, 30.0), (5.0, 30.0), (0.01, 25.0)])
def test_coarse_sampler_matches_jax(args):
    port, ref = frame_sampler.CoarseSampler(*args), jax_frame_sampler.CoarseSampler(*args)
    assert port.stride == ref.stride
    assert list(port.sample(1000, 7, 900)) == list(ref.sample(1000, 7, 900))
    assert list(port.sample(100)) == list(ref.sample(100))


@pytest.mark.parametrize("approx", [0, 50, 99])
def test_fine_and_adaptive_samplers_match_jax(approx):
    port, ref = frame_sampler.FineSampler(0.1, 1.0, 30.0), jax_frame_sampler.FineSampler(0.1, 1.0, 30.0)
    assert port.sample_around_target(approx, 100) == ref.sample_around_target(approx, 100)
    port, ref = frame_sampler.AdaptiveSampler(2.0, 30.0), jax_frame_sampler.AdaptiveSampler(2.0, 30.0)
    for conf in (0.9, 0.9, 0.1, 0.5, 0.1, 0.1, 0.1):
        assert port.adjust_interval(conf) == ref.adjust_interval(conf)
        assert port.stride == ref.stride


def test_video_processor_matches_jax(video):
    with VideoProcessor(video) as port, JaxVideoProcessor(video) as ref:
        assert (port.frame_count, port.fps, port.width, port.height) == (ref.frame_count, ref.fps, ref.width, ref.height)
        assert port.duration_seconds == ref.duration_seconds
        for n in (0, 37, 99, 100):
            got, want = port.get_frame(n), ref.get_frame(n)
            assert (got is None) == (want is None) and (got is None or np.array_equal(got, want))
        numbers = [3, 4, 20, 61, 98]
        got, want = list(port.iter_frames(numbers)), list(ref.iter_frames(numbers))
        assert [n for n, _ in got] == [n for n, _ in want] == numbers
        assert all(np.array_equal(g, w) for (_, g), (_, w) in zip(got, want))
        assert all(np.array_equal(g, w) for g, w in zip(port.get_frames([5, 6]), ref.get_frames([5, 6])))
        assert np.array_equal(port.read_next_frame(), ref.read_next_frame())


@pytest.mark.parametrize("mode", ["fetch", "iter"])
def test_prefetch_loader_matches_jax(video, mode):
    numbers = list(range(0, 100, 7))
    batches = {}
    for name, loader_cls, vp_cls in (("port", PrefetchLoader, VideoProcessor), ("jax", JaxPrefetchLoader, JaxVideoProcessor)):
        with vp_cls(video) as vp:
            kw = {"fetch_fn": vp.get_frame} if mode == "fetch" else {"iter_fn": vp.iter_frames}
            batches[name] = list(loader_cls(numbers, batch_size=4, depth=2, **kw))
    assert [n for n, _ in batches["port"]] == [n for n, _ in batches["jax"]]
    assert all(np.array_equal(g, w) for (_, g), (_, w) in zip(batches["port"], batches["jax"]))
    assert list(prefetch_iter(iter(range(9)), depth=2)) == list(jax_prefetch_iter(iter(range(9)), depth=2))


# ---------------------------------------------------------- Phase 1 itself
def _extraction_config(module, video, out, **timestamp):
    return module.from_dict({
        "video": {"input_path": str(video), "fps": 30, "frame_interval_minutes": 5, "tolerance_seconds": 60,
                  "time_compression_ratio": 313.0},
        "output": {"directory": str(out)},
        "timestamp": {"auto_targets": {"max_frames": 60, "disable_validation": True},
                      "sampling": {"coarse_interval_seconds": 0.5}, "extraction": {"confidence_threshold": 0.3},
                      **timestamp},
    })


def read_extraction_csv(path: Path) -> list[list[str]]:
    """extraction_results.csv with each frame path cut to its file name (the
    session directories differ)."""
    rows = list(csv.reader(path.open()))
    assert rows[0] == ["frame_number", "timestamp", "target_timestamp", "confidence", "time_error_seconds",
                       "frame_path"]
    return [rows[0]] + [r[:-1] + [Path(r[-1]).name] for r in rows[1:]]


def test_frame_extraction_pipeline_matches_jax(video, tmp_path):
    mode = "manual_targets"
    targets = [T0 + timedelta(minutes=5), T0 + timedelta(minutes=10, seconds=20)]
    outs = {}
    for name, module, pipeline_cls in (("port", ConfigManager, FrameExtractionPipeline),
                                       ("jax", JaxConfigManager, JaxFrameExtractionPipeline)):
        out = tmp_path / name
        pipeline = pipeline_cls(_extraction_config(module, video, out, extraction_mode=mode), out)
        extracted = pipeline.run(targets)
        outs[name] = (extracted, out, pipeline.extractor.get_cache_stats())
    (got, pout, pstats), (want, jout, jstats) = outs["port"], outs["jax"]
    assert read_extraction_csv(pout / "extraction_results.csv") == read_extraction_csv(jout / "extraction_results.csv")
    assert [(e.frame_number, e.timestamp, e.target_timestamp) for e in got] == [
        (e.frame_number, e.timestamp, e.target_timestamp) for e in want]
    assert len(got) >= 2 and pstats == jstats
    frames = sorted(p.name for p in (pout / "frames").iterdir())
    assert frames == sorted(p.name for p in (jout / "frames").iterdir()) and len(frames) == len(got)
    for name in frames:
        assert (pout / "frames" / name).read_bytes() == (jout / "frames" / name).read_bytes()
