"""Rotated BEV box families for the IoU kernels' tests, random and
adversarial to the clip's on-edge rule and to the matrix kernel's cull
(`iou_bev.clip_class_plain`).  Plain numpy: the card's tests import it
without jax (tests/test_torch_cuda.py), the CPU tests beside the reference
(tests/test_torch_nbr_iou_redesign.py)."""

import math

import numpy as np

FAMILIES = ["random", "identical_touching", "band", "tiny_edges",
            "zero_size", "far_degenerate"]


def _band_pairs():
    """A outside each edge of an axis-aligned or rotated B, at distances
    around the on-edge band 1e-3 / |edge| (0.5, 0.99, 1, 1.01, 2 and 4
    times it) and touching it."""
    a, b = [], []
    for heading in (0.0, math.pi / 2, 0.7):
        c, s = math.cos(heading), math.sin(heading)
        for dx, dy in ((4.0, 2.0), (0.5, 3.0)):
            for side, (nx, ny, half, other) in enumerate((
                    (0, 1, dy / 2, dx), (-1, 0, dx / 2, dy),
                    (0, -1, dy / 2, dx), (1, 0, dx / 2, dy))):
                band = 1e-3 / other
                for f in (0.0, 0.5, 0.99, 1.0, 1.01, 2.0, 4.0):
                    off = half + 0.5 + f * band   # A is 1 x 1, unrotated in B
                    lx, ly = nx * off, ny * off
                    b.append([1.0, -2.0, dx, dy, heading])
                    a.append([1.0 + lx * c - ly * s, -2.0 + lx * s + ly * c,
                              1.0, 1.0, heading])
    return a, b


def _far_degenerate_pairs():
    """A's edge along the extension of B's top edge line, 0.245 mm outside
    it (inside the band) and tilted by 1e-5 rad, 5 to 50 m away: the plain
    clip extrapolates a crossing point onto B's edge and returns a nonzero
    area, so no distance test may cull these."""
    a, b = [], []
    for cx in (5.0, 20.0, 50.0):
        for w in (1.0, 2.0):
            length, th = 2.0, 1e-5
            yc = 1.00049 + 0.5 * w * math.cos(th) + 0.5 * length * math.sin(th)
            a.append([cx, yc, length, w, th])
            b.append([0.0, 0.0, 2.0, 2.0, 0.0])
    return a, b


def pair_set(name):
    """(A, B) float32 box sets (N, 5) of one family; the matrix runs over
    every (A, B) combination, so each family also holds its cross pairs."""
    rng = np.random.RandomState(11)
    if name == "random":
        n = 160
        a = np.zeros((n, 5), np.float32)
        a[:, :2] = rng.uniform(-15, 15, (n, 2))
        a[:, 2:4] = rng.uniform(0.3, 5.0, (n, 2))
        a[:, 4] = rng.uniform(-math.pi, math.pi, n)
        a[::9, 4] = 0.0
        a[1::9, 4] = math.pi / 2
        b = a.copy()
        b[:40] = a[:40] + rng.normal(0, [0.3, 0.3, 0.1, 0.1, 0.2], (40, 5))
        b[:, 2:4] = np.abs(b[:, 2:4]) + 0.05
        return a, b
    if name == "identical_touching":
        base = [[0.0, 0.0, 4.0, 2.0, 0.0], [0.0, 0.0, 4.0, 2.0, math.pi / 2],
                [3.0, 1.0, 2.0, 2.0, 0.3]]
        a = base + [[4.0, 0.0, 4.0, 2.0, 0.0], [0.0, 2.0, 4.0, 2.0, 0.0],
                    [4.0, 2.0, 4.0, 2.0, 0.0], [0.0, 3.0, 2.0, 4.0,
                                                math.pi / 2],
                    [3.0 + 2 * math.cos(0.3), 1.0 + 2 * math.sin(0.3), 2.0,
                     2.0, 0.3]]
        return (np.asarray(a, np.float32),
                np.asarray(base + a[3:], np.float32))
    if name == "band":
        a, b = _band_pairs()
        return np.asarray(a, np.float32), np.asarray(b, np.float32)
    if name == "tiny_edges":
        a = np.zeros((24, 5), np.float32)
        a[:, :2] = rng.uniform(-1, 1, (24, 2))
        a[:, 2:4] = rng.choice([1e-6, 1e-4, 1e-2, 1.0], (24, 2))
        a[:, 4] = rng.uniform(-math.pi, math.pi, 24)
        return a, a.copy()
    if name == "zero_size":
        a = np.zeros((12, 5), np.float32)
        a[:6, :2] = rng.uniform(-3, 3, (6, 2))
        a[6:, :2] = rng.uniform(-3, 3, (6, 2))
        a[6:, 2:4] = rng.uniform(0.5, 4, (6, 2))
        a[6:, 4] = rng.uniform(-math.pi, math.pi, 6)
        a[9:, 2] = 0.0                      # one zero side
        return a, a.copy()                   # zero-size on either side
    if name == "far_degenerate":
        a, b = _far_degenerate_pairs()
        return np.asarray(a, np.float32), np.asarray(b, np.float32)
    raise ValueError(name)
