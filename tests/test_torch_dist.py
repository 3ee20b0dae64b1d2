"""Data parallelism of the port on the CPU: spawned gloo ranks
(tests/torch_dist_cases.py, a file:// rendezvous under tmp_path) against
one process on the global batch.

Why equality with one process is enough: the single-process port is held
to the JAX package (tests/test_torch_train_step.py,
tests/test_torch_train_det.py), and the JAX package's data parallelism,
a psum over the global batch, gives the single-device answer
(tests/test_multichip.py).  So W ranks on slices of a global batch must
give what one process gives on that batch, within float32 summation
order:

  (a) the synced masked BN: forward, input gradient, the scale and bias
      gradients (summed over ranks) and the running statistics within
      1e-6 relative, with and without a mask, channel last and NCHW;
  (b) the tiny float32 CenterPoint, 2 ranks x 1 sample against 1 process
      x 2 samples over 2 Trainer steps, each step from the ranks' state
      before it (Adam turns float32 rounding of near-zero gradient
      elements into +-lr, so trajectories part): loss and aux means within 1e-5
      relative, gnorm within 1e-4, every gradient leaf within 1e-3 of its
      leaf's max, 2e-2 in the 3D backbone (the bounds of the
      port-vs-reference gradient test, tests/test_torch_train_step.py:
      float32 summation order moves the sparse convs' gradients most),
      BN running statistics within 1e-5;
      the ranks bit-equal after each step;
  (c) steps_per_call=2 equals two single steps, and returns their means;
  (d) the sharded loader tiles the single-process global batches, pads
      the tail without drop_last, and at one rank equals the reference's
      loader bit for bit;
  (e) eval_gather keeps rank order; fit under 2 ranks keeps them
      bit-equal, logs the global loss from rank 0 alone and saves one
      checkpoint a save.
A group of one rank changes nothing, bit for bit.
"""

import json

import numpy as np
import pytest
import torch

from detzero_tpu.data import waymo_dataset as ref_waymo
from detzero_tpu_torch.core import mesh
from detzero_tpu_torch.data import waymo_dataset

import torch_dist_cases as dc

torch.set_num_threads(1)


# ----------------------------------------------------------------------
# (a) the masked BN


@pytest.fixture(scope="module")
def bn_ranks(tmp_path_factory):
    return {w: dc.spawn("bn_cases", w, tmp_path_factory.mktemp(f"bn{w}"))
            for w in (1, 2)}


@pytest.mark.parametrize("case", dc.BN_CASES, ids=[c[0] for c in dc.BN_CASES])
def test_synced_bn_equals_one_process(bn_ranks, case):
    name, shape, ch, masked = case
    x, mask, w = dc.bn_inputs(shape, ch, masked)
    one = dc.bn_run(x, mask, w, ch)
    ranks = [r[name] for r in bn_ranks[2]]

    def close(a, b, what):
        err = (a - b).abs().max().item()
        assert err <= 1e-6 * max(b.abs().max().item(), 1e-3), (what, err)

    for key in ("y", "dx"):
        close(torch.cat([r[key] for r in ranks]), one[key], key)
    for key in ("dscale", "dbias"):
        close(sum(r[key] for r in ranks), one[key], key)
    for key in ("mean", "var"):
        close(ranks[0][key], one[key], key)
        assert torch.equal(ranks[0][key], ranks[1][key]), key
    # one rank in a group of one: bit for bit the process without one
    solo = bn_ranks[1][0][name]
    for key in one:
        assert torch.equal(solo[key], one[key]), key


# ----------------------------------------------------------------------
# (b) the tiny CenterPoint


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(one process's steps, the 2 ranks' steps); one process starts each
    step from rank 0's state before it."""
    ranks = dc.spawn("tiny_steps", 2, tmp_path_factory.mktemp("tiny"))
    starts = [None] + [s["state"] for s in ranks[0][:-1]]
    return dc.tiny_steps(0, 1, None, starts=starts), ranks


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


@pytest.mark.parametrize("step", [0, 1])
def test_two_ranks_equal_one_process(tiny, step):
    one, ranks = tiny[0][step], [r[step] for r in tiny[1]]
    assert _rel(sum(r["loss"] for r in ranks) / 2, one["loss"]) <= 1e-5
    for k, v in one["aux"].items():
        got = torch.cat([r["aux"][k] for r in ranks])
        assert (got - v).abs().max() <= 1e-5 * max(v.abs().max(), 1e-3), k
    assert _rel(ranks[0]["gnorm"], one["gnorm"]) <= 1e-4
    for k, g in one["grads"].items():
        err = (ranks[0]["grads"][k] - g).abs().max().item()
        tol = 2e-2 if k.startswith("backbone3d.") else 1e-3
        assert err <= tol * max(g.abs().max().item(), 1e-6), (k, err)
    for k, b in one["buffers"].items():
        err = (ranks[0]["buffers"][k] - b).abs().max().item()
        assert err <= 1e-5 * max(b.abs().max().item(), 1.0), (k, err)


@pytest.mark.parametrize("step", [0, 1])
def test_ranks_stay_bit_equal(tiny, step):
    r0, r1 = (r[step] for r in tiny[1])
    assert r0["mismatch"] == r1["mismatch"] == []
    assert torch.equal(r0["gnorm"], r1["gnorm"])
    for key in ("grads", "buffers"):
        for k, v in r0[key].items():
            assert torch.equal(v, r1[key][k]), (key, k)
    # each rank's own loss is its own sample's
    assert not torch.equal(r0["loss"], r1["loss"])


# ----------------------------------------------------------------------
# (c) steps_per_call


def test_steps_per_call_equals_single_steps(tmp_path):
    batches = dc.toy_batches(4)
    single = dc.toy_trainer(tmp_path / "one")
    outs = [single.step(single.to_device(b)) for b in batches]
    multi = dc.toy_trainer(tmp_path / "two", steps_per_call=2)
    loss, aux, gnorm = multi.steps([multi.to_device(b) for b in batches[:2]])
    assert torch.equal(loss, torch.stack([o[0] for o in outs[:2]]).mean())
    assert torch.equal(gnorm, torch.stack([o[2] for o in outs[:2]]).mean())
    assert torch.equal(aux["mse"], torch.stack(
        [o[1]["mse"] for o in outs[:2]]).mean())
    # fit groups the batches in twos and drops a trailing partial group
    multi = dc.toy_trainer(tmp_path / "fit", steps_per_call=2, log_every=3)
    assert multi.fit(iter(batches + batches[:1]), 10, save_every=4) == 4
    a, b = single.state_dict(), multi.state_dict()
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for i, st in a["optimizer"]["state"].items():
        assert torch.equal(st["momentum_buffer"],
                           b["optimizer"]["state"][i]["momentum_buffer"])
    # logs at steps 4 (4 % 3 < 2) and saves at 4
    lines = [json.loads(x) for x in
             (tmp_path / "fit" / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines] == [4]
    assert multi.ckpt.all_steps() == [4]
    with pytest.raises(ValueError, match="steps_per_call"):
        dc.toy_trainer(steps_per_call=0)


# ----------------------------------------------------------------------
# (d) the loader


class _Indexed:
    """A dataset whose samples carry their index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"points": np.full((3, 2), i, np.float32),
                "points_valid": np.ones(3, bool), "frame_id": int(i)}

    def collate_batch(self, samples):
        return {"points": np.stack([s["points"] for s in samples]),
                "points_valid": np.stack([s["points_valid"]
                                          for s in samples]),
                "frame_id": np.array([s["frame_id"] for s in samples])}


@pytest.mark.parametrize("world,bs,n,drop", [(2, 2, 11, True),
                                             (3, 1, 10, True),
                                             (2, 2, 11, False),
                                             (3, 2, 7, False)])
def test_loader_shards_tile_global_batches(world, bs, n, drop):
    ds = _Indexed(n)
    one = waymo_dataset.build_dataloader(ds, bs * world, shuffle=True,
                                         seed=4, drop_last=drop)
    shards = [waymo_dataset.build_dataloader(ds, bs, shuffle=True, seed=4,
                                             drop_last=drop, rank=r,
                                             world=world, num_workers=r)
              for r in range(world)]
    for ep in range(2):
        glob = [b["frame_id"] for b in one(ep)]
        per = [list(s(ep)) for s in shards]
        assert all(len(p) == len(glob) for p in per)
        for g, parts in zip(glob, zip(*per)):
            ids = np.concatenate([p["frame_id"] for p in parts])
            assert all(len(p["frame_id"]) == bs for p in parts)
            # a short tail batch is filled up with copies of its last
            # sample, at its end
            assert np.array_equal(ids[:len(g)], g)
            assert (ids[len(g):] == g[-1]).all()
            assert len(g) == bs * world or (not drop and g is glob[-1])


def test_loader_one_rank_equals_reference():
    ds = _Indexed(9)
    for drop in (True, False):
        ref = ref_waymo.build_dataloader(ds, 2, shuffle=True, seed=3,
                                         drop_last=drop)
        got = waymo_dataset.build_dataloader(ds, 2, shuffle=True, seed=3,
                                             drop_last=drop, rank=0, world=1)
        for ep in range(2):
            a, b = list(ref(ep)), list(got(ep))
            assert len(a) == len(b)
            for x, y in zip(a, b):
                assert x.keys() == y.keys()
                for k in x:
                    assert np.array_equal(x[k], y[k]), k


# ----------------------------------------------------------------------
# (e) gather, fit under 2 ranks, the mesh


@pytest.fixture(scope="module")
def misc_ranks(tmp_path_factory):
    return dc.spawn("misc", 3, tmp_path_factory.mktemp("misc"))


def test_eval_gather_keeps_rank_order(misc_ranks):
    want = ["r0-0", "r1-0", "r1-1", "r2-0", "r2-1", "r2-2"]
    assert all(r["gather"] == want for r in misc_ranks)
    assert all(r["bcast"] == {"rank": 0} for r in misc_ranks)
    assert [r["mesh"] for r in misc_ranks] == [(i, 3) for i in range(3)]
    from detzero_tpu_torch.parallel.trainer import eval_gather
    assert eval_gather(["a", "b"]) == ["a", "b"]       # no group


def test_rank_draws(misc_ranks):
    """Rank 0 draws as one process; the others draw apart."""
    rngs = [r["rng"] for r in misc_ranks]
    assert np.array_equal(rngs[0],
                          np.random.RandomState(3).randint(1 << 30, size=4))
    assert not np.array_equal(rngs[0], rngs[1])
    assert not np.array_equal(rngs[1], rngs[2])
    assert [r["seed"] for r in misc_ranks] == [
        5 + i * mesh.RANK_SEED_STRIDE for i in range(3)]


@pytest.fixture(scope="module")
def fit_ranks(tmp_path_factory):
    """{world: (each rank's toy_fit, the ranks' directory)}."""
    out = {}
    for w in (1, 2):
        root = tmp_path_factory.mktemp(f"fit{w}")
        out[w] = (dc.spawn("toy_fit", w, root), root)
    return out


def test_fit_two_ranks(fit_ranks, tmp_path):
    one = dc.toy_fit(0, 1, tmp_path)
    r0, r1 = fit_ranks[2][0]
    assert [s[2] for s in r0["steps"]] == [[]] * 4
    for k, v in r0["state"]["model"].items():
        assert torch.equal(v, r1["state"]["model"][k]), k
        err = (v - one["state"]["model"][k]).abs().max()
        assert err <= 1e-5 * max(v.abs().max(), 1.0), k
    for a, b in zip(r0["steps"], one["steps"]):
        assert _rel(a[1], b[1]) <= 1e-5         # gnorm of the global batch
    # a group of one: bit for bit the process without one
    solo = fit_ranks[1][0][0]
    for k, v in solo["state"]["model"].items():
        assert torch.equal(v, one["state"]["model"][k]), k
    assert [s[:2] for s in solo["steps"]] == [s[:2] for s in one["steps"]]


def test_fit_two_ranks_writes_from_rank_zero(fit_ranks):
    ranks, root = fit_ranks[2]
    lines = [json.loads(x) for x in
             (root / "ckpt" / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines] == [1, 2, 3, 4]   # one line a step
    one = dc.toy_trainer()
    losses = []
    for b in dc.toy_batches(4):
        losses.append(float(one.step(one.to_device(b))[0]))
    for x, want in zip(lines, losses):
        assert abs(x["loss"] - want) <= 1e-5 * abs(want)
    assert sorted(p.name for p in (root / "ckpt").glob("*.pt")) == [
        "ckpt_4.pt"]
    saved = torch.load(root / "ckpt" / "ckpt_4.pt", weights_only=True)
    for k, v in ranks[0]["state"]["model"].items():
        assert torch.equal(saved["model"][k], v), k


def test_launcher_env(monkeypatch):
    """torchrun's and SLURM's variables, read without making a group."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "SLURM_PROCID",
              "SLURM_NTASKS", "SLURM_NODELIST", "SLURM_LOCALID",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert mesh._launcher_env() is None and mesh.local_rank() == 0
    assert mesh.init_distributed() == (0, 1)
    assert mesh.make_mesh().group is None and mesh.rank_device("cpu").type \
        == "cpu"
    monkeypatch.setenv("SLURM_PROCID", "3")
    monkeypatch.setenv("SLURM_NTASKS", "8")
    monkeypatch.setenv("SLURM_LOCALID", "1")
    monkeypatch.setenv("SLURM_NODELIST", "node7,node8")
    assert mesh._launcher_env() == (3, 8, 1, "tcp://node7:12355")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert mesh._launcher_env() == (1, 2, 1, "env://")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="cuda:1 does not exist"):
        mesh.rank_device("cuda")
    with pytest.raises(NotImplementedError, match="model=1"):
        mesh.make_mesh(model=2)
