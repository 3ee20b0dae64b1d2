"""The data-parallel entry points of the port on the CPU: `train_det.main`
then `test_det.main --data_parallel` on 2 spawned gloo ranks
(tests/torch_dist_cases.py) of configs/det_model_cfgs/
centerpoint_synthetic_cpu.yaml at a small layout (a 96 x 96 grid of
2048 points, 16 pillars a BEV row, one BEV layer a level, 3 frames, every
box of positive score kept),
against one process:

  * the ranks end bit-equal, and rank 0 alone writes the checkpoints, the
    metrics and the log;
  * the 2-rank checkpoint resumes in one process, which trains on to step
    3 from it;
  * test_det --data_parallel on it (a global batch of 2, the tail padded
    with a copy of frame 2) gives rank 0 the result.pkl that one process
    writes at batch 1, equal array for array: each rank predicts its
    frames at the batch of one process, so the arithmetic is the same;
  * a group of one rank trains and evaluates bit for bit as one process
    without a group.

Why equality with one process is enough: see tests/test_torch_dist.py."""

import json
import pickle
import shutil
import sys

import numpy as np
import pytest
import torch

from detzero_tpu_torch.tools import test_det, train_det

import torch_dist_cases as dc

torch.set_num_threads(1)

CFG = "configs/det_model_cfgs/centerpoint_synthetic_cpu.yaml"
SMALL = ["MODEL.PILLAR_ROW_BUDGET", "16", "MODEL.BEV_LAYER_NUMS", "[1, 1]",
         "SYNTHETIC_LENGTH", "3", "SYNTHETIC_POINTS", "2048",
         "NUM_POINT_BUDGET", "2048",
         "POINT_CLOUD_RANGE", "[-9.6, -9.6, -1.6, 9.6, 9.6, 1.6]",
         "MODEL.POST_PROCESSING.SCORE_THRESH", "0.0",
         "MODEL.POST_PROCESSING.NMS_POST_MAXSIZE", "16"]


def _argv(out):
    common = ["--cfg_file", CFG, "--device", "cpu", "--workers", "0",
              "--output_dir", str(out)]
    return (common + ["--log_every", "1", "--max_steps", "2", "--set",
                      *SMALL],
            common + ["--save_to_file", "--set", *SMALL])


def _exp(out):
    return out / "centerpoint_synthetic_cpu" / "default"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: (each rank's train_then_test, output dir)}."""
    out = {}
    for w in (1, 2):
        root = tmp_path_factory.mktemp(f"tools{w}")
        out[w] = (dc.spawn("train_then_test", w, root,
                           *_argv(root / "out")), root / "out")
    return out


def _same_annos(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert np.array_equal(np.asarray(x[k]), np.asarray(y[k])), k


def test_two_ranks_train_bit_equal(runs):
    (r0, r1), out = runs[2]
    assert r0["step"] == r1["step"] == 2
    assert r0["mismatch"] == r1["mismatch"] == []
    for k, v in r0["state"].items():
        assert torch.equal(v, r1["state"][k]), k
    exp = _exp(out)
    lines = [json.loads(x) for x in
             (exp / "ckpt" / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines] == [1, 2]
    assert all(np.isfinite(x["loss"]) and np.isfinite(x["gnorm"])
               for x in lines)
    # one log file of train_det, one of test_det: rank 0's
    assert len(r0["logfiles"]) == 1 and r1["logfiles"] == r0["logfiles"]
    assert len(list(exp.glob("log_test_*"))) == 1
    saved = torch.load(exp / "ckpt" / "ckpt_2.pt", weights_only=True)
    for k, v in r0["state"].items():
        assert torch.equal(saved["model"][k], v), k


def test_two_rank_checkpoint_resumes_in_one_process(runs, tmp_path,
                                                    monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    _, out = runs[2]
    shutil.copytree(out, tmp_path / "out")
    train_argv, _ = _argv(tmp_path / "out")
    train_argv[train_argv.index("--max_steps") + 1] = "3"
    trainer = train_det.main(train_argv)
    assert trainer.step_count == 3 and trainer.mesh.world == 1
    lines = (_exp(tmp_path / "out") / "ckpt" / "metrics.jsonl").read_text()
    assert [json.loads(x)["step"] for x in lines.splitlines()] == [1, 2, 3]


def test_data_parallel_result_equals_one_process(runs, tmp_path):
    (r0, r1), out = runs[2]
    assert r1["test"] is None and r0["test"]["samples"] == 2
    with open(r0["test"]["path"], "rb") as f:
        dp = pickle.load(f)
    _same_annos(dp, r0["test"]["det_annos"])
    assert [d["frame_id"] for d in dp] == [0, 1, 2]
    assert sum(len(d["name"]) for d in dp) > 0
    # one process at batch 1 on the same checkpoint
    shutil.copytree(out, tmp_path / "out")
    _, test_argv = _argv(tmp_path / "out")
    res = test_det.main(["--data_parallel"] + test_argv)   # no group
    assert res["timings"]["samples"] == 3
    _same_annos(dp, res["det_annos"])


def test_group_of_one_is_one_process(runs, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    (solo,), _ = runs[1]
    train_argv, test_argv = _argv(tmp_path)
    trainer = train_det.main(train_argv)
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, solo["state"][k]), k
    res = test_det.main(test_argv)
    _same_annos(res["det_annos"], solo["test"]["det_annos"])
