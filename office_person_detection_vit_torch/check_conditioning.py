"""How ill-conditioned two of ``chip_smoke.py``'s card-against-CPU checks are, on the CPU alone.

    python -m office_person_detection_vit_torch.check_conditioning [--check grads showcase] [--eps 1e-6]
        [--seeds 0 1 2] [--out DIR] [--small] [--json-out PATH]

The card's float32 attention kernels give outputs within about 1e-6 relative of the plain version's
(PERF.md §6). A check that holds a float32 run on the card against the same run on the CPU is well
conditioned when a difference of that size cannot flip it. This script runs each check's own comparison
CPU against CPU, one run with every attention output of the port's models multiplied by (1 + eps u), u
uniform in [-1, 1] from a generator seeded per seed (:func:`perturbed_attention`): the perturbed run
stands where the card's does. It prints how far the compared quantity moves against its bar, and what
carries the move:

- ``grads`` ([14a], ``chip_smoke.float32_grads_card_vs_cpu``): the VITW DETR's float32 gradients at
  224x224 (:func:`float32_grads`), each leaf against :data:`GRAD_RTOL` (:func:`worst_leaf`). First as the
  check compared them before, each run taking its own ReLU branches; then as it compares them now, the
  unperturbed run taking the perturbed run's branches (:class:`ReluBranches`); and which ReLU inputs
  changed sign, by the layer that feeds them.
- ``showcase`` ([11b], ``chip_smoke.showcase_phase``): the DETR-small showcase through ``main`` on the
  CPU, one Phase 1 and Phases 2-5 twice. First its tracks as the check compared them before
  (:func:`track_agreement`: one consistent id map, rows within 1.3 px and 2e-3); then the tracker's inputs
  as it compares them now (:func:`tracker_inputs_agree`: detections at [9b]'s bar, appearance features
  at :data:`FEATURE_RTOL`); and, where the tracks split, which input carries it: the tracker rerun on
  one run's detections with the other run's features (:func:`split_carrier`).

``--small`` runs ``grads`` on a DETR of tiny widths (the CPU test's size). Needs no card, and imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import csv
import importlib.util
import json
import logging
import shutil
import subprocess
import sys
import time
from datetime import datetime, timedelta
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
#: [14a]'s bar (chip_smoke.SMALL_GRAD_RTOL): each leaf's gradient within
#: 1e-3 of max(the leaf's max |grad|, 1e-3 of the largest leaf's).
GRAD_RTOL = 1e-3
#: The card's attention outputs against the plain version's, relative: 6.6e-7
#: to 2.0e-6 over the float32 K2 rows of attention_kernel_bench (PERF.md §6).
EPS = 1e-6
#: [14a]'s limits on the ReLU branches the CPU run takes from the card's:
#: each input whose sign parts lies within TIE_BAND of its call's largest
#: |input| (ten times the card's 1e-6 relative difference), and at most
#: PARTED_PER_MILLION of the inputs part. A card fault that flips signs of
#: inputs away from 0, or of many, fails them rather than being replayed.
TIE_BAND, PARTED_PER_MILLION = 1e-5, 5.0
#: [9b]'s bar on detections paired one to one: confidence, and each box
#: coordinate relative to the 1280 x 720 frame; an unpaired detection lies
#: within this of the confidence threshold.
DET_CONF_TOL, DET_BOX_TOL = 1e-3, 1e-3
#: The appearance features the tracker reads (DETR's encoder features pooled
#: under a box), card against CPU, relative to the detection's largest
#: |feature|: the repo's DETR bar on logits (rtol 1e-3).
FEATURE_RTOL = 1e-3
#: [11b]'s row bars before this script: a tracks_mot.csv row's box (px) and
#: confidence, card against CPU.
ROW_BOX_TOL, ROW_CONF_TOL = 1.3 + 0.01, 2e-3
#: The VITW DETR of chip_smoke.py [14a]: a ViT of 4 heads of 256, 2 layers.
VITW = dict(backbone="vit", vit_hidden=1024, vit_heads=4, vit_mlp=4096, vit_layers=2)
#: A DETR of tiny widths with a ViT backbone, for --small and the CPU test.
SMALL = dict(backbone="vit", vit_hidden=64, vit_heads=2, vit_mlp=128, vit_layers=1, d_model=32, num_heads=2,
             num_encoder_layers=2, num_decoder_layers=2, ffn_dim=64, num_queries=10)
SHOWCASE_FRAMES, SHOWCASE_THRESHOLDS = 600, (0.2, 0.3)


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def perturbed_attention(eps: float, seed: int):
    """Inside the block every attention output of the port's models
    (``models/transformer.py``'s ``multi_head_attention``: DETR's encoder
    and decoder, the ViT) is multiplied by (1 + eps u), u uniform in [-1, 1]
    from a torch generator seeded with ``seed``, one draw a call in call
    order. Its gradient is scaled the same way, as the card's backward pair
    differs from autograd of the plain version."""
    from .models import transformer

    plain = transformer.multi_head_attention
    gen = torch.Generator().manual_seed(seed)

    def noisy(q, k, v, key_padding_mask=None):
        out = plain(q, k, v, key_padding_mask)
        u = torch.rand(out.shape, generator=gen, dtype=torch.float64).mul_(2.0).sub_(1.0)
        return out * (1.0 + eps * u).to(out.device, out.dtype)

    transformer.multi_head_attention = noisy
    try:
        yield
    finally:
        transformer.multi_head_attention = plain


class ReluBranches:
    """The branch of every ``torch.relu`` call (input > 0), recorded in
    call order in one run (:meth:`record`) and taken in another
    (:meth:`replay`), where a call returns input times the recorded branch:
    its value moves by at most its input where the two runs part (a unit on
    the edge, |input| about the runs' difference), and its gradient takes
    the recording run's path. :meth:`replay` also counts the inputs whose
    sign parted, by the module entered last before the call (the layer that
    feeds it), and keeps each one's |input| and its |input| over its call's
    largest (:meth:`ties`)."""

    def __init__(self):
        self.masks: list[torch.Tensor] = []
        self.parted: dict[str, int] = {}
        self.parted_inputs: list[float] = []
        self.parted_rel: list[float] = []
        self.total = 0

    def ties(self) -> dict:
        """Whether the parted inputs of the last replay are near-ties: each
        within TIE_BAND of its call's largest |input|, and at most
        PARTED_PER_MILLION of all -> the readings, the limits and ``ok``."""
        parted = len(self.parted_rel)
        worst = max(self.parted_rel, default=0.0)
        cap = PARTED_PER_MILLION * 1e-6 * self.total
        return {"parted": parted, "inputs": self.total, "worst_rel": worst, "tie_band": TIE_BAND,
                "cap": cap, "ok": worst <= TIE_BAND and parted <= cap}

    @contextlib.contextmanager
    def _patched(self, relu, model: torch.nn.Module | None):
        plain, where = torch.relu, {"name": ""}
        hooks = [m.register_forward_pre_hook(lambda mod, args, name=name: where.update(name=name))
                 for name, m in (model.named_modules() if model is not None else [])]
        torch.relu = lambda x: relu(plain, x, where["name"])
        try:
            yield self
        finally:
            torch.relu = plain
            for h in hooks:
                h.remove()

    def record(self, model: torch.nn.Module | None = None):
        self.masks = []

        def relu(plain, x, _where):
            self.masks.append((x > 0).detach().cpu())
            return plain(x)

        return self._patched(relu, model)

    @contextlib.contextmanager
    def replay(self, model: torch.nn.Module | None = None):
        masks = iter(self.masks)
        self.parted, self.parted_inputs, self.parted_rel, self.total = {}, [], [], 0

        def relu(_plain, x, where):
            m = next(masks).to(x.device)
            off = m != (x > 0)
            self.total += m.numel()
            if bool(off.any()):
                self.parted[where] = self.parted.get(where, 0) + int(off.sum())
                inputs = x.detach()[off].abs().cpu()
                self.parted_inputs.extend(inputs.tolist())
                self.parted_rel.extend((inputs / x.detach().abs().max().cpu()).tolist())
            return x * m.to(x.dtype)

        with self._patched(relu, model):
            yield self
        if next(masks, None) is not None:
            raise RuntimeError("the replayed run called torch.relu fewer times than the recorded one")


def float32_grads(cfg, state: dict, pixels, mask, device="cpu", branches=None, mode: str | None = None) -> dict:
    """[14a]'s gradients: the DETR ``cfg`` with ``state`` in train mode on
    ``device``, TF32 off, the gradient of a fixed seeded projection of its
    logits and boxes (no matcher) -> {parameter name: its gradient on the
    CPU}. ``branches`` with ``mode`` "record" or "replay": its ReLU
    branches (:class:`ReluBranches`)."""
    from .device import full_float32
    from .models.detr import DETR

    model = DETR(cfg)
    model.load_state_dict(state)
    model.to(device).train()
    ctx = contextlib.nullcontext() if branches is None else getattr(branches, mode)(model)
    with full_float32(), ctx:
        out = model(pixels.to(device), mask.to(device))
        g = torch.Generator().manual_seed(1)
        loss = sum((out[key] * torch.randn(out[key].shape, generator=g).to(device)).sum()
                   for key in ("logits", "boxes"))
        model.zero_grad(set_to_none=True)
        loss.backward()
    return {k: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().cpu()
            for k, p in model.named_parameters()}


def worst_leaf(got: dict, want: dict) -> tuple[float, str]:
    """[14a]'s reading: the largest over leaves of max |got - want| over
    max(the leaf's max |want|, 1e-3 of the largest leaf's max |want|), and
    that leaf's name."""
    top = max(g.abs().max().item() for g in want.values())
    worst, worst_key = 0.0, ""
    for key, w in want.items():
        r = (got[key] - w).abs().max().item() / max(w.abs().max().item(), 1e-3 * top)
        if r > worst:
            worst, worst_key = r, key
    return worst, worst_key


def render_frames(n: int) -> np.ndarray:
    """chip_smoke.py's frames (``tests/helpers/synthetic_video.render_frame``:
    two people, five minutes apart)."""
    spec = importlib.util.spec_from_file_location("synthetic_video", ROOT / "tests" / "helpers" / "synthetic_video.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    t0 = datetime(2025, 1, 20, 9, 0, 0)
    return np.stack([mod.render_frame(t0 + timedelta(minutes=5 * i), people=[(300 + 20 * i, 300, 0),
                                                                             (800 - 15 * i, 360, 1)], seed=i)
                     for i in range(n)])


def grads_check(cfg, frames: np.ndarray, eps: float, seeds, hw=(224, 224)) -> dict:
    """[14a]'s comparison at each seed: the perturbed run (the card's place)
    records its ReLU branches; the unperturbed run takes its own (the check
    before) and then the perturbed run's (the check now)."""
    from .models.detr import DETR
    from .ops.preprocessing import preprocess_frames

    pixels, mask = preprocess_frames(torch.from_numpy(frames), target_hw=hw)
    ref = DETR(cfg)
    ref.init_weights(torch.Generator().manual_seed(0))
    state = ref.state_dict()
    t = time.perf_counter()
    own = float32_grads(cfg, state, pixels, mask)
    rows = []
    for seed in seeds:
        branches = ReluBranches()
        with perturbed_attention(eps, seed):
            card = float32_grads(cfg, state, pixels, mask, branches=branches, mode="record")
        taken = float32_grads(cfg, state, pixels, mask, branches=branches, mode="replay")
        before, before_key = worst_leaf(card, own)
        now, now_key = worst_leaf(card, taken)
        ties = branches.ties()
        rows.append({"seed": seed, "before": before, "before_key": before_key, "now": now, "now_key": now_key,
                     "relu_inputs": branches.total, "parted": branches.parted,
                     "parted_max_abs_input": max(branches.parted_inputs, default=0.0), "ties": ties})
        log(f"grads seed {seed}: worst leaf before {before:.3e} ({before_key}), now {now:.3e} ({now_key}); bar "
            f"{GRAD_RTOL:.0e}; {ties['parted']} of {branches.total} ReLU inputs changed sign (cap {ties['cap']:.1f}; "
            f"|input| <= {rows[-1]['parted_max_abs_input']:.2e}, <= {ties['worst_rel']:.2e} of its call's largest, "
            f"band {TIE_BAND:.0e}), after: {branches.parted}")
    return {"eps": eps, "rows": rows, "seconds": time.perf_counter() - t,
            "bar": GRAD_RTOL, "worst_before": max(r["before"] for r in rows),
            "worst_now": max(r["now"] for r in rows)}


# ---------------------------------------------------------------- showcase
class TrackerProbe:
    """The tracker's inputs of each run of ``main`` (the frames' detections
    with their appearance features, deep-copied before the tracker assigns
    ids) and the ids it assigned, with the phase's config: installed around
    ``TrackingPhase._run_online`` until :meth:`close`."""

    def __init__(self):
        from .pipeline.phases.tracking import TrackingPhase

        self.runs: list[dict] = []
        self._cls, self._plain = TrackingPhase, TrackingPhase._run_online
        plain, probe = self._plain, self

        def run_online(phase, frame_results, frames):
            inputs = copy.deepcopy(frame_results)
            ids = plain(phase, frame_results, frames)
            probe.runs.append({"config": phase.config, "inputs": inputs,
                               "ids": [[d.track_id for d in fr.detections] for fr in frame_results]})
            return ids

        TrackingPhase._run_online = run_online

    def close(self) -> None:
        self._cls._run_online = self._plain


def rerun_tracker(config, inputs: list) -> list:
    """The online tracker of ``config`` (the cascade, on the host) on a deep
    copy of ``inputs`` -> the ids it assigns, frame by frame."""
    from .pipeline.phases.tracking import TrackingPhase

    frame_results = copy.deepcopy(inputs)
    phase = TrackingPhase(config)
    phase.initialize()
    phase._run_online(frame_results, None)
    return [[d.track_id for d in fr.detections] for fr in frame_results]


def pair_detections(a: list, b: list, key=lambda d: d.bbox) -> tuple[list, list]:
    """One frame's detections of two runs paired one to one by the nearest
    box centre within 10 px (chip_smoke.matched); the rest of both."""
    def centre(d):
        x, y, w, h = key(d)
        return x + w / 2, y + h / 2

    pairs, rest = [], list(b)
    for d in a:
        j = min(range(len(rest)), key=lambda k: np.hypot(*np.subtract(centre(d), centre(rest[k]))), default=None)
        if j is not None and np.hypot(*np.subtract(centre(d), centre(rest[j]))) < 10:
            pairs.append((d, rest.pop(j)))
    left = [d for d in a if all(d is not p for p, _ in pairs)] + rest
    return pairs, left


def tracker_inputs_agree(card: list, cpu: list, threshold: float) -> dict:
    """[11b]'s comparison now, of the two runs' tracker inputs frame by
    frame: detections paired one to one (:func:`pair_detections`) within
    [9b]'s bar (confidence DET_CONF_TOL, each box coordinate DET_BOX_TOL of
    the 1280 x 720 frame), an unpaired one within DET_CONF_TOL of
    ``threshold``, and each pair's appearance features within FEATURE_RTOL
    of its largest |feature| -> the worst readings and whether all hold."""
    worst = {"conf": 0.0, "box": 0.0, "feature": 0.0}
    pairs_n, unpaired_far, missing_features = 0, [], 0
    for fa, fb in zip(card, cpu):
        pairs, left = pair_detections(fa.detections, fb.detections)
        unpaired_far += [(fa.frame_number, d.confidence) for d in left if abs(d.confidence - threshold) > DET_CONF_TOL]
        for a, b in pairs:
            pairs_n += 1
            worst["conf"] = max(worst["conf"], abs(a.confidence - b.confidence))
            worst["box"] = max(worst["box"], *(abs(x - y) / (1280 if i % 2 == 0 else 720)
                                               for i, (x, y) in enumerate(zip(a.bbox, b.bbox))))
            if (a.feature is None) != (b.feature is None):
                missing_features += 1
            elif a.feature is not None:
                fa_, fb_ = np.asarray(a.feature, np.float64), np.asarray(b.feature, np.float64)
                worst["feature"] = max(worst["feature"], np.abs(fa_ - fb_).max() / max(np.abs(fb_).max(), 1e-30))
    ok = (len(card) == len(cpu) and not unpaired_far and not missing_features and worst["conf"] <= DET_CONF_TOL
          and worst["box"] <= DET_BOX_TOL and worst["feature"] <= FEATURE_RTOL)
    return {"ok": ok, "pairs": pairs_n, "worst": worst, "unpaired_far": unpaired_far,
            "missing_features": missing_features}


def mot_rows(session: Path) -> dict:
    """tracks_mot.csv as {MOT frame: [(id, x, y, w, h, conf)]}."""
    rows = {}
    for r in csv.reader((session / "03_tracking" / "tracks_mot.csv").open()):
        rows.setdefault(int(r[0]), []).append((int(r[1]), *(float(v) for v in r[2:7])))
    return rows


def track_agreement(card_rows: dict, cpu_rows: dict) -> dict:
    """[11b]'s comparison before this script, as readings: tracks_mot.csv
    rows paired one to one by box centre, one consistent id map between the
    runs (the identity unless a row is in one run only, near a threshold),
    and each pair within ROW_BOX_TOL px and ROW_CONF_TOL. -> the first id
    conflicts, the rows left, the worst box and confidence, and whether the
    old check passes."""
    id_map, conflicts, left_far, rows_equal, left = {}, [], [], 0, 0
    worst_box = worst_conf = 0.0
    as_box = lambda r: r[1:5]  # noqa: E731
    for f in sorted(set(card_rows) | set(cpu_rows)):
        pairs, rest = pair_detections(card_rows.get(f, []), cpu_rows.get(f, []), key=as_box)
        left += len(rest)
        left_far += [(f, r) for r in rest if min(abs(r[5] - t) for t in SHOWCASE_THRESHOLDS) > 1.5e-3]
        for a, b in pairs:
            if id_map.setdefault(a[0], b[0]) != b[0]:
                conflicts.append({"frame": f, "card_id": a[0], "cpu_id": b[0], "cpu_id_before": id_map[a[0]]})
            worst_box = max(worst_box, *(abs(x - y) for x, y in zip(a[1:5], b[1:5])))
            worst_conf = max(worst_conf, abs(a[5] - b[5]))
            rows_equal += a[0] == b[0]
    one_to_one = len(set(id_map.values())) == len(id_map)
    identity = all(k == v for k, v in id_map.items())
    ok = (not conflicts and not left_far and one_to_one and (left > 0 or identity) and worst_box <= ROW_BOX_TOL
          and worst_conf <= ROW_CONF_TOL)
    return {"ok": ok, "conflicts": conflicts[:5], "n_conflicts": len(conflicts), "one_to_one": one_to_one,
            "identity": identity, "rows_same_id": rows_equal, "rows_left": left, "rows_left_far": left_far[:5],
            "worst_box_px": worst_box, "worst_conf": worst_conf}


def split_carrier(config, a_inputs: list, b_inputs: list, b_ids: list) -> dict:
    """Where two runs' tracks split, which tracker input carries it: the
    tracker rerun on the first run's detections with the second run's
    features, and on the second's with the first's (frames whose detections
    pair one to one), each against the second run's ids -> {input swapped:
    ids equal}."""
    def mixed(dets_from, feats_from):
        out = copy.deepcopy(dets_from)
        for fr, other in zip(out, feats_from):
            pairs, _ = pair_detections(fr.detections, other.detections)
            for d, o in pairs:
                d.feature = o.feature
        return out

    def ids_equal(x, y):  # frame by frame, whatever the order of the detections (None: a detection left untracked)
        def key(i):
            return (i is None, i or 0)

        return all(sorted(i, key=key) == sorted(j, key=key) for i, j in zip(x, y))

    return {"first run's detections, second's features": ids_equal(rerun_tracker(config, mixed(a_inputs, b_inputs)), b_ids),
            "second run's detections, first's features": ids_equal(rerun_tracker(config, mixed(b_inputs, a_inputs)), b_ids)}


def showcase_tool(*args: str) -> None:
    """``tools/e2e_showcase.py`` in a child process (gen-video, gen-config
    and gold-gt import nothing of the JAX package)."""
    out = subprocess.run([sys.executable, str(ROOT / "tools" / "e2e_showcase.py"), *args], capture_output=True,
                         text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"e2e_showcase {args[0]} exited {out.returncode}: {out.stderr[-2000:]}")


def resumable_copy(src: Path, dst: Path) -> Path:
    """A session for ``main --resume`` at ``dst`` holding only ``src``'s Phase
    1: its frames and extraction_results.csv (frame paths moved to the
    copy), metadata and config, and a checkpoint of 01_extraction alone."""
    shutil.copytree(src / "01_extraction", dst / "01_extraction")
    for name in ("metadata.json", "config.yaml"):
        shutil.copy(src / name, dst / name)
    state = json.loads((src / "pipeline_checkpoint.json").read_text())
    state["phases"] = {"01_extraction": state["phases"]["01_extraction"]}
    (dst / "pipeline_checkpoint.json").write_text(json.dumps(state))
    csv_path = dst / "01_extraction" / "extraction_results.csv"
    rows = list(csv.reader(csv_path.open()))
    for r in rows[1:]:
        r[-1] = str(dst / "01_extraction" / "frames" / Path(r[-1]).name)
    with csv_path.open("w", newline="") as f:
        csv.writer(f).writerows(rows)
    return dst


def run_main(cfg: dict, path: Path, *flags: str) -> tuple[int, float, list[Path]]:
    """``main.main`` on a YAML config, its console log in a file beside it
    -> the exit code, main's host seconds and the session directories under
    the config's output directory, by name."""
    import yaml

    from .main import main as port_main

    path.write_text(yaml.safe_dump(cfg))
    with path.with_suffix(".log").open("w") as console, contextlib.redirect_stdout(console):
        t = time.perf_counter()
        rc = port_main(["--config", str(path), *flags])
        secs = time.perf_counter() - t
        root = logging.getLogger()
        for handler in list(root.handlers):  # main's handlers write to the file and the session
            root.removeHandler(handler)
            handler.close()
    out = Path(cfg["output"]["directory"])
    return rc, secs, sorted(p for p in out.iterdir() if p.is_dir() and not p.is_symlink())


def main_session(cfg: dict, path: Path, *flags: str) -> Path:
    """:func:`run_main` -> the newest session; raises if main fails."""
    rc, _, sessions = run_main(cfg, path, *flags)
    if rc != 0:
        raise RuntimeError(f"main exited {rc}: {path.with_suffix('.log').read_text()[-3000:]}")
    return sessions[-1]


def showcase_check(out: Path, eps: float, seeds) -> dict:
    """[11b] on the CPU: the showcase video (gen-video) through ``main`` once
    (Phase 1 and Phases 2-5, the unperturbed run, the CPU's place), then for
    each seed Phases 2-5 again from its Phase 1 with the attention perturbed
    (the card's place); both comparisons and, where the tracks split, what
    carries it; the MOTA/IDF1 gap against the gold GT."""
    import yaml

    from .benchmark.mot_metrics import evaluate_mot, load_gold_gt, load_mot_csv

    out.mkdir(parents=True, exist_ok=True)
    video = out / "video.mp4"
    t = time.perf_counter()
    showcase_tool("gen-video", "--out", str(video), "--frames", str(SHOWCASE_FRAMES))
    showcase_tool("gen-config", "--video", str(video), "--weights",
                  str(ROOT / "docs" / "artifacts" / "detr_small_weights.npz"), "--out", str(out / "showcase.yaml"),
                  "--out-dir", str(out / "plain"), "--size", "small", "--score-mode", "sigmoid", "--conf", "0.2",
                  "--nms", "0.3", "--device", "cpu")
    cfg = yaml.safe_load((out / "showcase.yaml").read_text())
    cfg["detection"]["dtype"] = "float32"
    probe = TrackerProbe()
    try:
        plain = main_session(cfg, out / "plain.yaml")
        showcase_tool("gold-gt", "--session", str(plain), "--scenario", str(video.parent / "scenario.json"),
                      "--out", str(out / "gold.json"))
        gt = load_gold_gt(out / "gold.json")
        scores = {"plain": evaluate_mot(gt, load_mot_csv(plain / "03_tracking" / "tracks_mot.csv")).to_dict()}
        base = probe.runs[-1]
        rows = []
        for seed in seeds:
            pcfg = json.loads(json.dumps(cfg))
            pcfg["output"]["directory"] = str(out / f"perturbed_{seed}")
            session = resumable_copy(plain, out / f"perturbed_{seed}" / plain.name)
            with perturbed_attention(eps, seed):
                main_session(pcfg, out / f"perturbed_{seed}.yaml", "--resume", str(session))
            card = probe.runs[-1]
            got = evaluate_mot(gt, load_mot_csv(session / "03_tracking" / "tracks_mot.csv")).to_dict()
            before = track_agreement(mot_rows(session), mot_rows(plain))
            now = tracker_inputs_agree(card["inputs"], base["inputs"], cfg["detection"]["confidence_threshold"])
            row = {"seed": seed, "before": before, "now": now,
                   "score_gap": {k: abs(got[k] - scores["plain"][k]) for k in ("mota", "idf1")}}
            if before["n_conflicts"] or not before["ok"]:
                row["carrier"] = split_carrier(base["config"], base["inputs"], card["inputs"], card["ids"])
            rows.append(row)
            log(f"showcase seed {seed}: before {'passes' if before['ok'] else 'FAILS'} ({before['n_conflicts']} id "
                f"conflicts, first {before['conflicts'][:1]}; {before['rows_same_id']} rows with the same id, "
                f"{before['rows_left']} in one run only; box {before['worst_box_px']:.2e} px, confidence "
                f"{before['worst_conf']:.2e}); now {'passes' if now['ok'] else 'FAILS'} (detections "
                f"{now['pairs']} paired: confidence {now['worst']['conf']:.2e}, box {now['worst']['box']:.2e} of the "
                f"frame, features {now['worst']['feature']:.2e}; {len(now['unpaired_far'])} unpaired away from the "
                f"threshold); MOTA/IDF1 gap "
                f"{row['score_gap']}; carrier {row.get('carrier', '-')}")
    finally:
        probe.close()
    return {"eps": eps, "rows": rows, "seconds": time.perf_counter() - t, "scores": scores}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--check", nargs="+", choices=["grads", "showcase"], default=["grads", "showcase"])
    p.add_argument("--eps", type=float, default=EPS)
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--out", type=Path, default=Path("output") / "conditioning", help="the showcase's videos and sessions")
    p.add_argument("--small", action="store_true", help="grads on a DETR of tiny widths")
    p.add_argument("--json-out", type=Path)
    args = p.parse_args(argv)
    from .models.detr import DETRConfig

    results = {"eps": args.eps, "seeds": args.seeds}
    if "grads" in args.check:
        cfg = DETRConfig(dtype="float32", dropout=0.0, **(SMALL if args.small else VITW))
        results["grads"] = grads_check(cfg, render_frames(2), args.eps, args.seeds,
                                       hw=(64, 64) if args.small else (224, 224))
        log(f"grads ([14a], {'tiny widths' if args.small else 'VITW DETR'}): worst leaf before "
            f"{results['grads']['worst_before']:.3e}, now {results['grads']['worst_now']:.3e} (bar {GRAD_RTOL:.0e}), "
            f"{results['grads']['seconds']:.1f} s")
    if "showcase" in args.check:
        results["showcase"] = showcase_check(args.out, args.eps, args.seeds)
    if args.json_out:
        args.json_out.parent.mkdir(parents=True, exist_ok=True)
        args.json_out.write_text(json.dumps(results, indent=1, default=str))
    return results


if __name__ == "__main__":
    main()
