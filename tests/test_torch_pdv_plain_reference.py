"""The two-stage detector (`SECOND_STAGE`, the PDV RoI head) of
detzero_tpu_torch against the benchmark's plain float32 reference
(`benchmark/reference/pdv.py`) on the CPU: the benchmark's tiny geometry
with ROI_BUDGET 16, ROI_GRID_SIZE 3 and ROI_ATTENTION, float32, weights
drawn by `benchmark/weights.py` and calibrated by the cell's entry
(`benchmark/entries/pdv_predict.py`).

`CenterPoint.predict`'s RoI head, on its own proposals, against
`pdv.forward` given the same proposals: the logits, residuals, refined
boxes and scores within 1e-4 (relative L2 gap, over the valid RoIs; the
first stage's float32 sums run in another order), the voxel query's
neighbour sets and counts exactly; with the attention left out of the
program alone the comparison fails.  The reference's first stage is
`network.forward`'s, bit for bit, and its calibration sets the first
stage's statistics as `weights.calibrate` does."""

import json
from pathlib import Path

import pytest
import torch

from benchmark import harness, resolve, scene, weights
from benchmark.reference import network, pdv
from detzero_tpu_torch.models.detection import pdv_head

ROOT = Path(__file__).resolve().parents[1]
TINY = ROOT / "benchmark" / "tests" / "tiny"
SEED = 2_147_483_659
TOL = 1e-4


def gap(got, ref):
    got, ref = got.double(), ref.double()
    return float((got - ref).norm() / ref.norm().clamp(min=1e-30))


@pytest.fixture(scope="module")
def setup():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    config = json.loads((TINY / "configs" / "tiny.json").read_text())
    config["MODEL"].update(SECOND_STAGE=True, ROI_BUDGET=16, ROI_GRID_SIZE=3,
                           ROI_ATTENTION=True)
    mix = json.loads((TINY / "traffic" / "tiny_b2.json").read_text())
    entry = resolve.entry("pdv_predict")
    rcfg = entry.roi_cfg(config, harness.reference_cfg(config))
    model = harness.build_model(config, "cpu")
    pool = scene.make_pool(mix, SEED, config["NUM_POINT_BUDGET"],
                           config["MAX_OBJS"], "cpu")
    pts, valid = pool["points"][:2], pool["points_valid"][:2]
    sd = weights.make(harness.state_shapes(model), SEED, "cpu")
    first = weights.calibrate(dict(sd), pts[:1], valid[:1], rcfg)
    sd = entry.calibrate(sd, pts[:1], valid[:1], rcfg)
    model.load_state_dict(sd)
    yield entry, model, sd, rcfg, pts, valid, first
    torch.set_num_threads(threads)


def predict(entry, model, pts, valid, monkeypatch):
    """The program's predict of the batch: its output, per frame the
    entry's captures, and per RoI head call and level the voxel query's
    (idx, found) with the level's (cells, nz)."""
    seen = entry.Seen(model)
    seen.on = True
    queries, levels = [], []
    query = pdv_head.pillars.voxel_query_pillar

    def keep(*args, **kw):
        queries.append(query(*args, **kw))
        return queries[-1]

    monkeypatch.setattr(pdv_head.pillars, "voxel_query_pillar", keep)
    hook = model.roi_head.register_forward_hook(
        lambda mod, args, out: levels.extend(
            (lv["cells"][0], lv["grid_zyx"][0]) for lv in args[2]))
    try:
        out = model.predict(pts, valid)
    finally:
        hook.remove()
    return out, seen.take(), list(zip(queries, levels))


def reference(sd, rcfg, pts, valid, got):
    """pdv.forward on the RoIs the program's head received."""
    heads = [h for _, _, h in got]
    props = [p for _, p, _ in got]
    given = {"boxes": torch.cat([h["rois"] for h in heads]),
             "mask": torch.cat([h["mask"] for h in heads]),
             "scores": torch.cat([p["scores"] for p in props]),
             "labels": torch.cat([p["labels"] for p in props])}
    return given, pdv.forward(sd, pts, valid, rcfg, proposals=given)[1]


@pytest.fixture(scope="module")
def sound(setup):
    entry, model, sd, rcfg, pts, valid, _ = setup
    with pytest.MonkeyPatch.context() as mp:
        out, got, queries = predict(entry, model, pts, valid, mp)
    given, ref = reference(sd, rcfg, pts, valid, got)
    return out, got, queries, given, ref


def test_reference_first_stage_is_network_forward(setup):
    _, _, sd, rcfg, pts, valid, first = setup
    maps, _ = pdv.forward(sd, pts, valid, rcfg)
    ref, _ = network.forward(sd, pts, valid, rcfg)
    for m, r in zip(maps, ref):
        for k in r:
            assert torch.equal(m[k], r[k]), k
    for k, v in first.items():
        if not k.startswith("roi_head."):
            assert torch.equal(sd[k], v), k


@pytest.mark.parametrize("what", ["cls_logit", "reg_deltas", "boxes",
                                  "scores"])
def test_roi_head_matches_reference(sound, what):
    out, got, _, given, ref = sound
    mask = given["mask"]
    assert int(mask.sum()) >= 16, "too few RoIs to compare"
    program = {"cls_logit": torch.cat([h["cls"] for _, _, h in got]),
               "reg_deltas": torch.cat([h["reg"] for _, _, h in got]),
               "boxes": out["boxes"], "scores": out["scores"]}[what]
    assert gap(program[mask], ref[what][mask]) <= TOL


@pytest.mark.parametrize("level", [0, 1])
def test_neighbour_sets_equal(sound, level):
    """The program's query of each frame, as voxel keys, equals the
    reference's key lookup slot for slot, and so do the found counts."""
    _, got, queries, _, ref = sound
    for b in range(len(got)):
        (idx, found), (cells, nz) = queries[b * len(pdv.ROI_LEVELS) + level]
        idx = idx.long()
        keys = torch.where(found, cells[idx // nz].long() * nz + idx % nz,
                           -1)
        assert torch.equal(keys, ref["neighbours"][level][b])
        assert torch.equal(found.sum(1), ref["counts"][level][b])
    assert int(ref["counts"][level].sum()) > 0


def test_attention_left_out_fails_the_comparison(setup, monkeypatch):
    entry, model, sd, rcfg, pts, valid, _ = setup
    model.roi_head.with_attention = False
    try:
        _, got, _ = predict(entry, model, pts, valid, monkeypatch)
    finally:
        model.roi_head.with_attention = True
    given, ref = reference(sd, rcfg, pts, valid, got)
    mask = given["mask"]
    cls = torch.cat([h["cls"] for _, _, h in got])
    assert gap(cls[mask], ref["cls_logit"][mask]) > 100 * TOL
