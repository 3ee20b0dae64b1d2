"""`run_det` of the port's synthetic ladder
(`detzero_tpu_torch.tools.ladder_synthetic`) against the JAX tool's
(`tools/ladder_synthetic.py`) on the CPU, at tests/test_torch_ladder.py's
tiny geometry, float32 on both sides: 2 val frames at batch 2, the port's
detector from a torch checkpoint of the reference's variables carried
across by convert.py (non-trivial BN statistics), the reference's
checkpoint stubbed with the same variables; the same frames, names and
keep counts, boxes and scores within 1e-4 * max(|ref|, 1).  A missing
checkpoint raises, and so does the default device without a card."""

import numpy as np
import pytest
import torch

from detzero_tpu_torch.convert import convert_centerpoint, to_flax
from detzero_tpu_torch.core.checkpoint import CheckpointManager
from detzero_tpu_torch.core.config import Config, cfg_from_yaml_file
from detzero_tpu_torch.core.logger import create_logger
from detzero_tpu_torch.tools import common, ladder_synthetic
import detzero_tpu.core.checkpoint as ref_checkpoint
from detzero_tpu.core.config import Config as RefConfig
from detzero_tpu.core.config import cfg_from_yaml_file as ref_cfg_from_yaml
from tools import ladder_synthetic as ref_ladder

from test_torch_convert import randomize_stats
from test_torch_ladder import VAL_SEED, write_cfg

torch.set_num_threads(1)


@pytest.fixture
def setup(tmp_path):
    path = write_cfg(tmp_path)
    cfg = cfg_from_yaml_file(str(path), Config())
    model = common.build_detector(cfg, "cpu", dtype=torch.float32, seed=3)
    v = randomize_stats(to_flax(model.state_dict()), 7)
    model.load_state_dict(convert_centerpoint(v, model), strict=True)
    ckpt = tmp_path / "det_ckpt"
    CheckpointManager(ckpt).save(3, {"model": model.state_dict()})
    return {"tmp": tmp_path, "cfg": cfg, "v": v, "ckpt": ckpt,
            "ref_cfg": ref_cfg_from_yaml(str(path), RefConfig())}


def test_run_det_matches_the_reference(setup, monkeypatch):
    """2 val frames at batch 2 through both tools' run_det."""
    logger = create_logger()
    datasets = [ref_ladder.build_synthetic(setup["ref_cfg"], VAL_SEED, 1),
                ladder_synthetic.build_synthetic(setup["cfg"], VAL_SEED, 1)]
    for ds in datasets:
        ds.length = 2

    class Restored:
        def __init__(self, ckpt_dir):
            pass

        def restore_any(self):
            v = setup["v"]
            return {"params": v["params"],
                    "batch_stats": v["batch_stats"]}, 3

    monkeypatch.setattr(ref_checkpoint, "CheckpointManager", Restored)
    want = ref_ladder.run_det(setup["ref_cfg"], "unused", datasets[0],
                              logger, batch_size=2)
    timings = {}
    got = ladder_synthetic.run_det(setup["cfg"], setup["ckpt"],
                                   datasets[1], logger, batch_size=2,
                                   device="cpu", timings=timings)
    assert timings["frames"] == len(got) == len(want) == 2
    kept = 0
    for a, b in zip(want, got):
        assert (a["frame_id"], a["sequence_name"]) == \
            (b["frame_id"], b["sequence_name"])
        assert np.array_equal(a["name"], b["name"])
        for k in ("boxes_lidar", "score"):
            r = np.asarray(a[k])
            assert r.shape == b[k].shape
            assert np.abs(b[k] - r).max() <= 1e-4 * max(np.abs(r).max(),
                                                          1.0), k
        kept += len(a["name"])
    assert kept > 2
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        ladder_synthetic.run_det(setup["cfg"], setup["tmp"] / "none",
                                 datasets[1], logger, device="cpu")
    # the card unless the caller names the CPU: no card raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ladder_synthetic.run_det(setup["cfg"], setup["ckpt"], datasets[1],
                                 logger)
