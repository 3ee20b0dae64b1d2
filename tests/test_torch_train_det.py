"""The detection training entry point of the port on the CPU: the slice as
a whole (both packages' first loader batch through the reference's
CenterPoint.loss and the port's Trainer.step, within 1e-4 relative, the
bound of tests/test_torch_train_step.py), checkpoints (rotation, the
shape-tolerant partial load, a resumed `fit` equal to an unbroken one bit
for bit, one- and two-stage, the second stage's RoI draws a function of
(seed, step), and weights carried both ways between an orbax checkpoint of the
reference and a torch checkpoint of the port, with equal predictions), and
the CLI (`detzero_tpu_torch.tools.train_det.main`: train, resume, and its
refusals)."""

import copy
import json
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from detzero_tpu.core import checkpoint as ref_checkpoint
from detzero_tpu.core.config import Config as RefConfig
from detzero_tpu.data import waymo_dataset as ref_waymo
from detzero_tpu.models.detection.centerpoint import CenterPoint as JaxCP
from detzero_tpu_torch.convert import convert_centerpoint, to_flax
from detzero_tpu_torch.core import checkpoint
from detzero_tpu_torch.core.config import Config
from detzero_tpu_torch.core.optim import build_optimizer
from detzero_tpu_torch.data import waymo_dataset
from detzero_tpu_torch.models.detection.centerpoint import CenterPoint
from detzero_tpu_torch.parallel.trainer import Trainer
from detzero_tpu_torch.tools import train_det

import torch_data_cases as cases
from test_torch_convert import KW, randomize_stats
from test_torch_optim import FLAGSHIP_OPT
from test_torch_train_step import TRAIN_CFG

torch.set_num_threads(1)

F = len(cases.FEATURES)          # 6 point features, the loader's
SEED = 7
DECODE = dict(score_thresh=0.0, nms_thresh=0.3)
# test_torch_train_step.py's geometry and pillar budgets; one BEV layer a
# level and 32 pillars a BEV row (the plain row-pad convs' cost is linear
# in the row budget: a step takes 2.3 s on one CPU thread against 11 s at
# 128), 16 for the resume test's eight steps
SMALL_CFG = dict(TRAIN_CFG, BEV_LAYER_NUMS=(1, 1), PILLAR_ROW_BUDGET=32)
RESUME_CFG = dict(SMALL_CFG, PILLAR_ROW_BUDGET=16)
# the PDV second stage as tests/test_torch_two_stage_train.py sizes it
RESUME2_CFG = dict(RESUME_CFG, SECOND_STAGE=True, ROI_BUDGET=16,
                   ROI_GRID_SIZE=3, ROI_ATTENTION=True)


def tiny_model(seed=0, cfg=SMALL_CFG):
    m = CenterPoint(cfg, 3, dtype=torch.float32, device="cpu",
                    num_point_features=F, **KW)
    return m.init_parameters(torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def loader_batches(tmp_path_factory):
    """The first 4 training batches of both packages' loaders on the tiny
    Waymo tree (GT sampling from an in-memory database, the world
    transforms), 2 samples each."""
    tree = cases.write_tree(tmp_path_factory.mktemp("waymo"))
    db = cases.gt_database()
    out = []
    for pkg, cfg_cls, rng in ((ref_waymo, RefConfig, None),
                              (waymo_dataset, Config, True)):
        cfg = cfg_cls(cases.tree_cfg(tree))
        if rng is None:
            np.random.seed(SEED)
            ds = pkg.WaymoDetectionDataset(cfg, cases.CLASS_NAMES, True)
        else:
            ds = pkg.WaymoDetectionDataset(cfg, cases.CLASS_NAMES, True,
                                           rng=np.random.RandomState(SEED))
        ds.augmentor.queue[0][0].set_database(copy.deepcopy(db))
        loader = pkg.build_dataloader(ds, 2, shuffle=True, seed=1)
        out.append([b for ep in range(4) for b in loader(ep)])
    ref, got = out
    for a, b in zip(ref, got):
        for k, v in a.items():
            if isinstance(v, np.ndarray):
                assert np.array_equal(v, b[k]), k
    return got


ARRAYS = ("points", "points_valid", "gt_boxes", "gt_classes", "gt_valid")


def test_first_loader_batch_loss(loader_batches):
    """The slice as a whole: loader batch -> the reference's loss and the
    port's Trainer.step, on the same weights and BN statistics."""
    batch = loader_batches[0]
    assert batch["gt_boxes"].shape == (2, 8, 9) and batch["gt_valid"].any()
    model = tiny_model()
    v = randomize_stats(to_flax(model.state_dict()), 4)
    jm = JaxCP(RefConfig(SMALL_CFG), 3, dtype=jnp.float32, **KW)
    loss_ref, (aux_ref, _) = jax.jit(jm.loss)(v, *(batch[k] for k in ARRAYS))
    model.load_state_dict(convert_centerpoint(v, model), strict=True)
    trainer = Trainer(model, build_optimizer(FLAGSHIP_OPT, 10, model))
    loss, aux, gnorm = trainer.step(trainer.to_device(batch))
    assert abs(float(loss) - float(loss_ref)) <= 1e-4 * abs(float(loss_ref))
    assert aux.keys() == aux_ref.keys()
    for k in aux:
        a, b = np.asarray(aux_ref[k]), aux[k].numpy()
        assert np.abs(a - b).max() <= 1e-4 * max(np.abs(a).max(), 1e-3), k
    assert torch.isfinite(gnorm) and trainer.step_count == 1


def test_checkpoint_rotation(tmp_path):
    mgr = checkpoint.CheckpointManager(tmp_path / "ckpt", max_to_keep=3)
    assert mgr.latest_step() is None
    assert mgr.restore_any() == (None, None)
    for step in range(1, 7):
        mgr.save(step, {"w": torch.full((3,), float(step)), "step": step,
                        "nested": {"t": (torch.ones(2), 1.5)}})
    assert mgr.all_steps() == [4, 5, 6] and mgr.latest_step() == 6
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "ckpt_4.pt", "ckpt_5.pt", "ckpt_6.pt"]
    state, step = mgr.restore_any(5)
    assert step == 5 and state["step"] == 5
    assert torch.equal(state["w"], torch.full((3,), 5.0))
    assert torch.equal(state["nested"]["t"][0], torch.ones(2))


def test_load_params_partial_one_mismatch():
    """A state_dict with one entry of another shape: every other entry is
    copied, that one keeps the model's own value."""
    src, dst = tiny_model(1), tiny_model(2)
    loaded = dict(src.state_dict())
    bad = "center_head.head0.hm_out.weight"
    loaded[bad] = torch.zeros(loaded[bad].shape[0] + 1,
                              *loaded[bad].shape[1:])
    keep = dst.state_dict()[bad].clone()
    n = checkpoint.load_params_partial(dst, loaded)
    assert n == len(loaded) - 1
    for k, v in dst.state_dict().items():
        assert torch.equal(v, keep if k == bad else src.state_dict()[k]), k


def _fit(batches, total, ckpt_dir, cfg=RESUME_CFG):
    model = tiny_model(cfg=cfg)
    trainer = Trainer(model, build_optimizer(FLAGSHIP_OPT, 4, model),
                      ckpt_dir=ckpt_dir, log_every=1, seed=SEED)
    trainer.resume()
    trainer.fit(iter(batches), total)
    return trainer


def _assert_resumed_equals_unbroken(batches, tmp_path, cfg):
    """2 steps, a new trainer resumed from their checkpoint, 2 more: the
    weights, BN statistics, optimizer and schedule state and the logged
    metrics equal those of 4 unbroken steps, bit for bit.  Returns the
    logged lines."""
    whole = _fit(batches, 4, tmp_path / "whole", cfg)
    first = _fit(batches[:2], 2, tmp_path / "split", cfg)
    assert first.step_count == 2
    resumed = _fit(batches[2:], 4, tmp_path / "split", cfg)
    assert resumed.step_count == 4
    a, b = whole.state_dict(), resumed.state_dict()
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        assert sa[i]["count"] == sb[i]["count"] == 4
        assert torch.equal(sa[i]["mu"], sb[i]["mu"])
        assert torch.equal(sa[i]["nu"], sb[i]["nu"])
    assert a["scheduler"] == b["scheduler"]
    assert whole.optimizer.lr == resumed.optimizer.lr
    logs = [[json.loads(x) for x in
             (tmp_path / d / "metrics.jsonl").read_text().splitlines()]
            for d in ("whole", "split")]
    drop = ("ms_per_it",)
    assert [{k: v for k, v in x.items() if k not in drop} for x in logs[0]] \
        == [{k: v for k, v in x.items() if k not in drop} for x in logs[1]]
    assert len(logs[0]) == 4
    assert [p.name for p in sorted((tmp_path / "split").glob("*.pt"))] == [
        "ckpt_2.pt", "ckpt_4.pt"]
    return logs[0]


def test_resumed_fit_equals_unbroken(loader_batches, tmp_path):
    _assert_resumed_equals_unbroken(loader_batches, tmp_path, RESUME_CFG)


def test_resumed_two_stage_fit_equals_unbroken(loader_batches, tmp_path):
    """The same with the PDV second stage, whose RoI subsample draws from
    the trainer's generator of (seed, step): the logged RoI terms too."""
    logs = _assert_resumed_equals_unbroken(loader_batches, tmp_path,
                                           RESUME2_CFG)
    assert {"roi_cls", "roi_reg"} <= logs[0].keys()


def test_roi_draws_follow_the_step():
    """The generator of a step draws what a new trainer with the same
    seed draws at that step, and other numbers at the next step or under
    another seed."""
    model = tiny_model(cfg=RESUME2_CFG)
    opt = build_optimizer(FLAGSHIP_OPT, 4, model)

    def draws(seed, step):
        trainer = Trainer(model, opt, seed=seed)
        trainer.step_count = step
        return model.roi_draws(2, trainer.step_generator())

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    assert same(draws(SEED, 3), draws(SEED, 3))
    for other in (draws(SEED, 4), draws(SEED, 2), draws(SEED + 1, 3)):
        assert not any(torch.equal(x, y)
                       for x, y in zip(draws(SEED, 3), other))


def test_fit_writes_a_profile(loader_batches, tmp_path):
    """profile_dir: a torch.profiler trace of the steps in profile_range,
    here the first of two."""
    model = tiny_model(cfg=RESUME_CFG)
    trainer = Trainer(model, build_optimizer(FLAGSHIP_OPT, 2, model),
                      prefetch=0)
    assert trainer.fit(iter(loader_batches), 2, profile_dir=tmp_path / "p",
                       profile_range=(0, 1)) == 2
    traces = list((tmp_path / "p").glob("trace_*.json"))
    assert len(traces) == 1
    assert json.loads(traces[0].read_text())["traceEvents"]


@pytest.fixture(scope="module")
def reference_predict():
    """The reference's tiny model (6 point features), its variables (drawn
    by the port, with non-trivial BN statistics) and its jitted predict
    over variables."""
    rng = np.random.RandomState(5)
    pts = rng.uniform(-6, 6, (1, 2048, F)).astype(np.float32)
    pts[..., 2] = rng.uniform(-1.8, 1.8, (1, 2048))
    pv = rng.rand(1, 2048) > 0.05
    jm = JaxCP(RefConfig(SMALL_CFG), 3, dtype=jnp.float32, **KW)
    v = randomize_stats(to_flax(tiny_model(4).state_dict()), 7)
    predict = jax.jit(lambda v_: jm.predict(v_, pts, pv, **DECODE))
    return pts, pv, v, lambda v_: jax.tree.map(np.asarray, predict(v_))


def _assert_same_predictions(ref, got):
    m = ref["mask"][0]
    gm = got["mask"].numpy()[0]
    assert 0 < m.sum() and int(gm.sum()) == int(m.sum())
    assert np.array_equal(got["labels"].numpy()[0][gm], ref["labels"][0][m])
    assert np.abs(got["boxes"].numpy()[0][gm] - ref["boxes"][0][m]).max() \
        <= 1e-3


def test_weights_carried_between_checkpoints(reference_predict, tmp_path):
    """An orbax checkpoint of the reference, restored template-free,
    converted and partially loaded into the port, predicts as the
    reference; the port's torch checkpoint, restored, converted back with
    to_flax and partially loaded into the reference's tree, predicts as
    the port."""
    pts, pv, v, predict = reference_predict
    ref_mgr = ref_checkpoint.CheckpointManager(tmp_path / "orbax")
    ref_mgr.save(3, {"params": v["params"], "batch_stats": v["batch_stats"],
                     "step": np.int32(3)})
    raw, step = ref_mgr.restore_any()
    assert step == 3
    model = tiny_model(9)
    sd = convert_centerpoint({"params": raw["params"],
                              "batch_stats": raw["batch_stats"]}, model)
    assert checkpoint.load_params_partial(model, sd) == len(sd) \
        == len(model.state_dict())
    got = model.predict(torch.from_numpy(pts), torch.from_numpy(pv),
                        **DECODE)
    _assert_same_predictions(predict(v), got)

    # and back: the port's checkpoint into a fresh reference tree
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(0.9)
    mgr = checkpoint.CheckpointManager(tmp_path / "torch")
    trainer = Trainer(model, build_optimizer(FLAGSHIP_OPT, 4, model))
    mgr.save(5, trainer.state_dict())
    state, step = mgr.restore_any()
    assert step == 5 and state["step"] == 0
    back = to_flax(state["model"])
    fresh = jax.tree.map(np.zeros_like, v)
    loaded = {"params": ref_checkpoint.load_params_partial(
                  fresh["params"], back["params"]),
              "batch_stats": ref_checkpoint.load_params_partial(
                  fresh["batch_stats"], back["batch_stats"])}
    got = model.predict(torch.from_numpy(pts), torch.from_numpy(pv),
                        **DECODE)
    _assert_same_predictions(predict(loaded), got)


CLI_CFG = "configs/det_model_cfgs/centerpoint_synthetic_cpu.yaml"


def test_cli_trains_and_resumes(tmp_path, monkeypatch):
    """Two steps, then resumed to three, at the synthetic CPU config with
    the small layout of the tests above (16 pillars a row, one BEV layer a
    level, set through --set); without TensorBoard, as on the card's
    machine (importing it here loads TensorFlow, 12 s)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    args = ["--cfg_file", CLI_CFG, "--device", "cpu", "--workers", "0",
            "--output_dir", str(tmp_path), "--log_every", "1"]
    small = ["--set", "MODEL.PILLAR_ROW_BUDGET", "16",
             "MODEL.BEV_LAYER_NUMS", "[1, 1]"]      # --set takes the rest
    assert train_det.main(args + ["--max_steps", "2"] + small).step_count \
        == 2
    trainer = train_det.main(args + ["--max_steps", "3"] + small)
    assert trainer.step_count == 3
    exp = tmp_path / "centerpoint_synthetic_cpu" / "default"
    lines = [json.loads(x) for x in
             (exp / "ckpt" / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines] == [1, 2, 3]
    assert all(np.isfinite(x["loss"]) and np.isfinite(x["gnorm"])
               for x in lines)
    assert trainer.ckpt.all_steps() == [2, 3] and trainer.tb is None
    assert trainer.model.row_budget == 16
    assert (exp / "centerpoint_synthetic_cpu.yaml").exists()
    saved, _ = trainer.ckpt.restore_any()
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(saved["model"][k], v), k


def test_cli_refusals(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    args = ["--cfg_file", CLI_CFG, "--workers", "0", "--output_dir",
            str(tmp_path), "--max_steps", "1"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_det.main(args)                     # --device cuda by default
    with pytest.raises(ValueError, match="steps_per_call"):
        train_det.main(args + ["--device", "cpu", "--steps_per_call", "0"])
