"""Point streams for the stream VFE's tests (kernel K1), edge cases of its
row windows: rows with empty windows, a voxel of more points than one
chunk of the CUDA kernel (256) or two, a short voxel crossing the end of a
chunk whose first point continues a longer one (the kernel hands both
voxels' sums over in that chunk), lanes at and past the row budget,
points of weight 0, a padded tail past the last window, and a tile too
large for the kernel's shared memory in float32 (built in z-slabs).  Plain
numpy: the card's tests import it without jax (tests/test_torch_cuda.py),
the CPU tests beside the reference
(tests/test_torch_nms_vfe_redesign.py)."""

import numpy as np

F = 5
P_PAD = 2048          # the stream padded to 16 lane tiles of 128
SCENES = ["empty_rows", "big_voxel", "chunk_carry", "lanes_past_b", "weight0",
          "slabs"]


def _row(rng, n_vox, b, nz, lane_hi, big=()):
    """One BEV row's (lane, z, count) runs, sorted by (lane, z); `big`
    gives the point counts of the first runs."""
    n_vox = min(n_vox, lane_hi * nz)
    slots = np.sort(rng.choice(lane_hi * nz, n_vox, replace=False))
    counts = rng.randint(1, 5, n_vox)
    counts[:len(big)] = big[:n_vox]
    return [(s // nz, s % nz, c) for s, c in zip(slots, counts)]


def vfe_scene(name):
    """{payload (P_PAD, F+1) f32, lane, z (P_PAD,) i32, wstart (ny+1,) i32,
    nz, ny, b}: the stream sorted by (row, lane, z), each voxel's points
    contiguous, the padded tail past wstart[ny] holding junk."""
    rng = np.random.RandomState(SCENES.index(name) + 7)
    ny, nz, b = 12, 4, 32
    lane_hi, weight0 = b, 0.0
    rows = []
    if name == "empty_rows":
        rows = [[] if y % 3 != 1 else _row(rng, 40, b, nz, b)
                for y in range(ny)]
        rows[0] = []
        rows[-1] = []
    elif name == "big_voxel":
        rows = [_row(rng, 20, b, nz, b) for y in range(ny)]
        rows[3] = _row(rng, 30, b, nz, b, big=(300,))
        rows[7] = _row(rng, 10, b, nz, b, big=(600, 257))
    elif name == "chunk_carry":
        # row 5: a 300-point voxel runs into the second 256-point chunk,
        # 211 points of short voxels follow, then a 2-point voxel at 511
        # and 512 crosses that chunk's end; row 9 the same a chunk later
        rows = [_row(rng, 20, b, nz, b) for y in range(ny)]
        runs = (300,) + (4,) * 52 + (3, 2, 1, 1)
        rows[5] = _row(rng, len(runs), b, nz, b, big=runs)
        rows[9] = _row(rng, 70, b, nz, b, big=(256 + 300,) + runs[1:])
    elif name == "lanes_past_b":
        lane_hi = b + 12
        rows = [_row(rng, 60, b, nz, lane_hi) for y in range(ny)]
    elif name == "weight0":
        weight0 = 0.4
        rows = [_row(rng, 50, b, nz, b) for y in range(ny)]
    elif name == "slabs":
        ny, nz, b = 6, 64, 128
        rows = [_row(rng, 80, b, nz, b) for y in range(ny)]
    else:
        raise ValueError(name)
    lane, z, wstart = [], [], [0]
    for runs in rows:
        for l, zz, c in runs:
            lane += [l] * c
            z += [zz] * c
        wstart.append(len(lane))
    p = len(lane)
    assert p <= P_PAD, (name, p)
    payload = rng.uniform(-50, 50, (P_PAD, F + 1)).astype(np.float32)
    w = (rng.rand(P_PAD) >= weight0).astype(np.float32)
    payload[:, F] = w
    # features of an out-of-budget point are zero, as the table makes them,
    # except in the weight-0 scene, where they stay to show the divisor
    if name != "weight0":
        payload[:, :F] *= w[:, None]
    lane_a = np.full(P_PAD, b + 3, np.int32)
    z_a = np.full(P_PAD, nz + 1, np.int32)
    lane_a[:p], z_a[:p] = lane, z
    lane_a[p:] = rng.randint(0, b, P_PAD - p)     # junk in the tail
    z_a[p:] = rng.randint(0, nz, P_PAD - p)
    return dict(payload=payload, lane=lane_a, z=z_a,
                wstart=np.asarray(wstart, np.int32), nz=nz, ny=ny, b=b)
