"""``check_conditioning``'s comparisons at a small size, on the CPU.

[14a]'s gradient comparison with the ReLU branches taken from one run
(``ReluBranches``, ``grads_check`` on a DETR of tiny widths), and [11b]'s
comparison of the tracker's inputs (``tracker_inputs_agree``) beside its
old comparison of the tracks (``track_agreement``) and the tracker reruns
that name what carries a split (``split_carrier``), on
frames made here. The perturbation of the attention outputs is seeded, so
each reading is the same from run to run.
"""

import copy
from datetime import datetime, timedelta

import numpy as np
import pytest
import torch

from office_person_detection_vit_torch import check_conditioning as cc
from office_person_detection_vit_torch.core.dto import Detection, FrameResult
from office_person_detection_vit_torch.models.detr import DETRConfig
from tests.helpers.torch_threads import two_torch_threads  # noqa: F401 (autouse: 2 torch threads)


def test_relu_branches_send_the_gradient_down_the_recorded_path():
    """A unit whose input is 1e-7 in one run and -1e-7 in the other: the
    second run's own ReLU stops its gradient; replaying the first run's
    branch lets it through, as in the first run, and counts the one input
    whose sign parted. A replay that calls ReLU fewer times raises."""
    lin = torch.nn.Linear(2, 3, bias=False)
    with torch.no_grad():
        lin.weight.copy_(torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]]))
    grads = []
    branches = cc.ReluBranches()
    for x0, mode in ((1e-7, "record"), (-1e-7, None), (-1e-7, "replay")):
        x = torch.tensor([[x0, -1.0]], requires_grad=True)
        with getattr(branches, mode)(lin) if mode else torch.enable_grad():
            torch.relu(lin(x)).sum().backward()
        grads.append(x.grad.tolist())
    assert grads == [[[1.0, 0.0]], [[0.0, 0.0]], [[1.0, 0.0]]]
    assert branches.parted == {"": 1} and branches.total == 3
    assert branches.parted_inputs == [pytest.approx(1e-7)] and branches.parted_rel == [pytest.approx(1e-7)]
    ties = branches.ties()
    assert ties["parted"] == 1 and ties["inputs"] == 3 and not ties["ok"]  # 1 of 3 is over five per million
    branches.total = 10**6
    assert branches.ties()["ok"]
    branches.parted_rel = [2 * cc.TIE_BAND]
    assert not branches.ties()["ok"]  # an input away from 0 is no tie
    with pytest.raises(RuntimeError, match="fewer times"), branches.replay(lin):
        pass


def test_grads_comparison_holds_with_the_recorded_branches():
    """[14a]'s comparison at tiny widths, the attention outputs of one run
    perturbed by 1e-6 (the card's size): with that run's ReLU branches the
    other run's gradients are within the bar, and the readings name a leaf
    and count every ReLU input."""
    cfg = DETRConfig(dtype="float32", dropout=0.0, **cc.SMALL)
    frames = (np.random.default_rng(0).random((2, 96, 128, 3)) * 255).astype(np.uint8)
    got = cc.grads_check(cfg, frames, cc.EPS, [0, 1], hw=(64, 64))
    assert [r["seed"] for r in got["rows"]] == [0, 1]
    assert all(r["now"] <= cc.GRAD_RTOL and r["now_key"] and r["relu_inputs"] > 0 for r in got["rows"])
    assert all(r["ties"]["inputs"] == r["relu_inputs"] and r["ties"]["parted"] == sum(r["parted"].values())
               for r in got["rows"])
    assert got["worst_now"] == max(r["now"] for r in got["rows"]) <= got["worst_before"] + cc.GRAD_RTOL


def _frames(n=4, people=2):
    t0 = datetime(2025, 1, 20, 9, 0, 0)
    rng = np.random.default_rng(3)
    return [FrameResult(frame_number=30 * i, timestamp=t0 + timedelta(minutes=i),
                        detections=[Detection(bbox=(100.0 + 300 * p + 5 * i, 200.0, 60.0, 150.0),
                                              confidence=0.9 - 0.1 * p, feature=rng.standard_normal(8).astype(np.float32))
                                    for p in range(people)])
            for i in range(n)]


_TRACKING = {"tracking.enabled": True, "tracking.max_age": 30, "tracking.min_hits": 1}


def test_tracker_inputs_comparison_and_the_old_track_comparison():
    """The inputs of two runs 1e-6 apart pass [9b]'s bar and the features'
    one; a confidence off by 0.4, or a detection of one run only away from
    the threshold, fails it (one near it passes). The tracker rerun on one
    run's inputs gives that run's ids. The old comparison of the tracks
    passes equal tracks and fails one id map that changes in mid-run."""
    a = _frames()
    b = copy.deepcopy(a)
    for fr in b:
        for d in fr.detections:
            d.confidence += 1e-6
            d.bbox = tuple(x + 1e-4 for x in d.bbox)
            d.feature = d.feature * np.float32(1 + 1e-6)
    now = cc.tracker_inputs_agree(b, a, 0.2)
    assert now["ok"] and now["pairs"] == 8 and now["worst"]["feature"] < 1e-5
    off = copy.deepcopy(b)
    off[1].detections[0].confidence = 0.5
    assert not cc.tracker_inputs_agree(off, a, 0.2)["ok"]
    far, near = copy.deepcopy(b), copy.deepcopy(b)
    far[2].detections.append(Detection(bbox=(900.0, 100.0, 40.0, 90.0), confidence=0.7))
    near[2].detections.append(Detection(bbox=(900.0, 100.0, 40.0, 90.0), confidence=0.2005))
    assert not cc.tracker_inputs_agree(far, a, 0.2)["ok"] and cc.tracker_inputs_agree(near, a, 0.2)["ok"]

    ids = cc.rerun_tracker(_TRACKING, a)
    assert ids == cc.rerun_tracker(_TRACKING, a) and sorted({i for f in ids for i in f}) == [1, 2]
    assert cc.split_carrier(_TRACKING, a, b, cc.rerun_tracker(_TRACKING, b)) == {
        "first run's detections, second's features": True, "second run's detections, first's features": True}

    rows = {f: [(i, *d.bbox, d.confidence) for i, d in zip(fid, fr.detections)]
            for f, (fid, fr) in enumerate(zip(ids, a))}
    assert cc.track_agreement(rows, copy.deepcopy(rows))["ok"]
    swapped = copy.deepcopy(rows)
    swapped[2] = [(3 - r[0], *r[1:]) for r in swapped[2]]
    old = cc.track_agreement(swapped, rows)
    assert not old["ok"] and old["n_conflicts"] == 2 and old["conflicts"][0]["frame"] == 2
