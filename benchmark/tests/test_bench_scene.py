"""The LiDAR scene generator: deterministic in the seed, the point budget
and the beam count kept, GT only where the scene put points."""

import json
import math
from pathlib import Path

import torch

from benchmark import scene

HERE = Path(__file__).resolve().parent
MIX = json.loads((HERE / "tiny" / "traffic" / "tiny_b2.json").read_text())
LIDAR5 = json.loads((HERE.parent / "traffic" / "lidar5_b4.json").read_text())


def pool(seed, budget=3000):
    return scene.make_pool(MIX, seed, budget, 8, "cpu")


def test_deterministic_in_the_seed():
    a, b, c = pool(3_000_000_017), pool(3_000_000_017), pool(5)
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["points"], c["points"])


def test_point_budget_and_columns():
    p = pool(11, budget=2000)
    assert p["points"].shape == (MIX["pool_frames"], 2000, 6)
    assert bool(p["points_valid"].all())      # the sweeps overfill it
    # the current sweep first, older sweeps after, time offsets -k * dt
    t = p["points"][0, :, 5]
    assert float(t[0]) == 0.0
    assert set(torch.unique(t).tolist()) <= {
        -round(k * MIX["sweep_dt_s"], 6) for k in range(MIX["sweeps"])} | {0.0}
    assert bool((torch.diff(t) <= 1e-7).all())


def test_beams_and_range():
    """Every point lies on one of the beams' elevations from where the
    sensor was, within the range."""
    gen = torch.Generator().manual_seed(3)
    sc = scene._place(MIX, gen, [1, 1, 0, 1], "cpu")
    pts = scene._sweep(dict(MIX, range_noise_m=0.0), gen, sc, 0, 0.0, "cpu")
    d = pts[:, :3] - torch.tensor([0.0, 0.0, MIX["sensor_height_m"]])
    r = d.norm(dim=1)
    assert float(r.max()) <= MIX["max_range_m"] + 1e-3
    elev = torch.rad2deg(torch.asin(d[:, 2] / r))
    beams = torch.linspace(MIX["beam_top_deg"], MIX["beam_bottom_deg"],
                           MIX["beams"])
    nearest = (elev[:, None] - beams[None]).abs().min(1)
    assert float(nearest.values.max()) < 1e-2
    assert len(torch.unique(nearest.indices)) <= MIX["beams"]
    assert LIDAR5["beams"] == 64 and LIDAR5["azimuth_steps"] == 2650


def test_gt_has_its_points():
    p = pool(23)
    assert int(p["gt_valid"].sum()) > 0
    for f in range(MIX["pool_frames"]):
        v = p["gt_valid"][f]
        if not bool(v.any()):
            continue
        boxes = p["gt_boxes"][f][v]
        counts = scene._points_in_boxes(p["points"][f][p["points_valid"][f]],
                                        boxes[:, :7])
        assert int(counts.min()) >= MIX["min_points"]
        assert bool((p["gt_classes"][f][v] <= 2).all())


def test_every_seed_gets_the_same_sizes():
    lo, hi = LIDAR5["objects"]["Vehicle"]["count"]
    full = [scene._spread(lo, hi, LIDAR5["pool_frames"], k)
            for k in range(LIDAR5["pool_frames"])]
    assert min(full) >= lo and max(full) <= hi
    assert math.isclose(sum(full) / len(full), (lo + hi) / 2, rel_tol=0.05)
