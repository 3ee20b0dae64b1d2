"""Stage timing of the port outside and inside the flagship model (port of
tools/bisect_perf.py).

    python -m detzero_tpu_torch.tools.bisect_perf micro prefix
    python -m detzero_tpu_torch.tools.bisect_perf fusegap
    BISECT_ONLY=sort_ids,pallas_conv_l0 python -m \\
        detzero_tpu_torch.tools.bisect_perf micro
    python -m detzero_tpu_torch.tools.bisect_perf micro prefix fusegap \\
        --device cpu --scale tiny

Each stage is one callable on tensors already on the device.  On the card
`per_iter_ms` is the mean of `--iters` calls back to back as the host
enqueues them, from CUDA events (a call's Python and launch cost included
where it outlasts its kernels), and `ms` the card's own time of one call:
for micro's stages, one op or kernel each, the calls queued behind a spin
kernel so that the events read the kernels back to back
(`chip_smoke.time_ms`); for prefix's and fusegap's, whose calls launch
many kernels and wait on the card to read sizes, the union of the card's
kernel intervals under torch.profiler (`chip_profile.busy_ms`), with
`idle_share` 1 - ms / per_iter_ms.  On the CPU (`--device cpu`, the tests'
route) both are the host's clock.  One JSON line a stage:
{"stage", "ms", "per_iter_ms", "iters", "group", "scale", ...}; the first
line names the device and, on the card, its name and power limit as
`nvidia-smi --query-gpu=name,power.limit` gives them.  The lines are
appended to output/bisect_perf.json.  `BISECT_ONLY` (comma-separated keys,
the reference's) keeps only those stages.

Groups (the reference's stage names where the op is the same; `--scale
tiny` runs each at the CPU tests' size under the same name):
  * micro: the ops of the table, the plan, the row-pad convs and decode at
    the flagship's sizes (160k points, 120k voxels, a 40 x 1504 x 1504
    grid, 128 pillars a row), outside the model: the sorts, searchsorted,
    the row LUT's build and lookup, the gathers, the sorted segment sums
    and the scatters, cumsum and topk, the capped unique of
    `downsample_pillars`, K10's NMS, the BEV backbone and head, the BEV
    densify, and the row-pad kernels on random maps: K4 'subm' at L0, L1
    and L3 (pallas_conv_l{0,1,3}_rowpad), K9 (pallas_conv_l0_sliding), K2
    (pallas_conv_l0_fusedbn), K4 'down' L0 -> L1 (pallas_conv_l0_down) and
    K5 at L0 (pallas_dw_l0);
  * prefix: the flagship (`chip_smoke.FLAGSHIP_CFG`, bf16, seeded weights)
    on entry()'s 160k points, once in each site mode: the table, the
    table and plan, the backbone and head on a prebuilt plan, the forward
    and predict;
  * fusegap: the forward's prefix piece by piece, in each site mode: the
    table alone, the base plan, the row-pad maps, the network on a
    prebuilt plan, the whole forward, and the 3D backbone from its input
    to the end of each level (events where each level's down conv, and
    the z conv, begin; their `ms` read with the calls queued behind a
    spin kernel, as micro's).

Not ported, since the port does not do their work: `lut_build` and
`lut_lookup` (a dense voxel LUT of 90M cells; the port's LUT is the BEV
row LUT), `ss_sort_method` (jnp.searchsorted's sort method),
`gather_l0` and `gather_sorted` (the sorted-table backend's 27-gather
conv), `gather_pillar*`, `gather3d*`, `conv1d_z`, `conv1d_big`,
`pillar_conv_l0`, `pbev_gather` and `pzconv` (the XLA gather backend's
pillar conv, which the port leaves out by design), `take_dense_bev` (empty
in the reference), `cumsum_comp` (a compensated scan no route uses), and
fusegap's `fg_net_const` and `fg_forward_barrier` (XLA's jit constants and
optimization barrier).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from detzero_tpu_torch.ops.pillars import SITE_MODES

REPO = Path(__file__).resolve().parents[2]
OUTPUT = REPO / "output" / "bisect_perf.json"
# the flagship's sizes, and the CPU tests' beside them
SCALES = {
    "full": dict(points=160_000, voxels=120_000, grid=(40, 1504, 1504),
                 extent=70.0, row_budget=128, pillars=64_000, nms=1024),
    "tiny": dict(points=2048, voxels=1024, grid=(8, 64, 64), extent=6.0,
                 row_budget=16, pillars=512, nms=64),
}


def chip_smoke():
    """chip_smoke.py at the root of the checkout, whose flagship, input and
    card timing this tool shares."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    return cs


class Stages:
    """Times and prints the stages of one group on one device, and appends
    their records to `out`."""

    def __init__(self, group, device, scale, iters, out, only=None):
        self.group, self.device, self.scale = group, device, scale
        self.iters, self.out, self.only = iters, out, only
        # prefix's and fusegap's stages are whole pieces of the model
        self.busy = group != "micro"

    def want(self, key):
        return self.only is None or key in self.only

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _host_paced(self, fn, marks=None):
        """Mean ms of `iters` calls; with `marks` (a list the call fills
        with (name, mark) where its pieces end), the mean ms from the
        call's start to each mark too."""
        cuda = self.device.type == "cuda"

        def mark():
            if not cuda:
                return time.perf_counter()
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev

        def ms(a, b):
            return a.elapsed_time(b) if cuda else (b - a) * 1e3

        for _ in range(2):
            fn()
        self._sync()
        runs = []
        for _ in range(self.iters):
            if marks is not None:
                marks.clear()
            t0 = mark()
            fn()
            runs.append((t0, list(marks or ()), mark()))
        self._sync()
        total = sum(ms(a, b) for a, _, b in runs) / self.iters
        pieces = {}
        for a, ms_marks, _ in runs:
            for name, m in ms_marks:
                pieces[name] = pieces.get(name, 0.0) + ms(a, m) / self.iters
        return total, pieces

    def time(self, name, fn, note=None, **fields):
        """Times fn(); prints and records its line."""
        per_iter, _ = self._host_paced(fn)
        ms = per_iter
        if self.device.type == "cuda" and self.busy:
            ms = self._busy_ms(fn)
            fields["idle_share"] = 1.0 - ms / per_iter
        elif self.device.type == "cuda":
            ms = chip_smoke().time_ms(fn, iters=self.iters, warmup=1)
        return self.record(name, ms, per_iter, note, **fields)

    def _busy_ms(self, fn):
        """The card's busy ms a call over `iters` calls under
        torch.profiler."""
        from torch.profiler import ProfilerActivity, profile

        chip_smoke()
        from chip_profile import busy_ms

        self._sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(self.iters):
                fn()
            self._sync()
        return busy_ms(prof) / self.iters

    def record(self, name, ms, per_iter, note=None, **fields):
        rec = {"stage": name, "ms": ms, "per_iter_ms": per_iter,
               "iters": self.iters, "group": self.group,
               "scale": self.scale, **fields}
        if note:
            rec["note"] = note
        self.out.append(rec)
        print(json.dumps(rec), flush=True)
        return rec


# ---------------------------------------------------------------------------
# micro
# ---------------------------------------------------------------------------

def sorted_voxels(s, rng):
    """Sorted unique voxel ids (int32, INVALID-padded to s['voxels']) and
    their zyx coords, from voxelizing the synthetic cloud."""
    nz, ny, nx = s["grid"]
    e = s["extent"]
    pts = rng.uniform(-e, e, (s["points"], 3))
    pts[:, 2] = rng.uniform(-1.5, 3.5, s["points"])
    lo = np.array([-(e + 5.2), -(e + 5.2), -2.0])
    vs = np.array([2 * (e + 5.2) / nx, 2 * (e + 5.2) / ny, 6.0 / nz])
    idx = np.floor((pts - lo) / vs).astype(np.int64)
    ok = ((idx >= 0) & (idx < np.array([nx, ny, nz]))).all(1)
    ids = np.unique((idx[ok, 2] * ny + idx[ok, 1]) * nx + idx[ok, 0])
    ids = ids[:s["voxels"]]
    out = np.full(s["voxels"], np.iinfo(np.int32).max, np.int64)
    out[:len(ids)] = ids
    coords = np.stack([out // (ny * nx), out // nx % ny, out % nx], 1)
    coords[len(ids):] = 0
    return out.astype(np.int32), coords, len(ids)


def rowpad_fixture(ny, b, nz, cin, device, rng, ny_out=None, b_out=None):
    """A random bf16 row-pad table (ny, nz*cin, b) and neighbour map
    (ny_out, 16, b_out) with 40% of the taps absent (rank b)."""
    from detzero_tpu_torch.ops.pillars import NBR_ROWS

    ny_out = ny_out or ny
    b_out = b_out or b
    tab = torch.from_numpy(rng.randn(ny, nz * cin, b).astype(np.float32))
    nbr = rng.randint(0, b, (ny_out, NBR_ROWS, b_out))
    nbr[rng.rand(*nbr.shape) < 0.4] = b
    nbr[:, 9:] = b
    return (tab.to(device, torch.bfloat16),
            torch.from_numpy(nbr.astype(np.int32)).to(device))


def run_micro(st, model_for):
    from detzero_tpu_torch.ops import nms, pillars, rowpad_conv

    s = SCALES[st.scale]
    dev = st.device
    rng = np.random.RandomState(1)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    nz, ny, nx = s["grid"]
    p, v, b = s["points"], s["voxels"], s["row_budget"]
    npil = s["pillars"]
    ids32, coords, _ = sorted_voxels(s, rng)
    ids = t(ids32)
    pts = t(rng.uniform(-s["extent"], s["extent"], (p, 5)).astype(np.float32))

    # -- sorts ---------------------------------------------------------------
    if st.want("sort_points"):
        st.time("sort_points_argsort160k", lambda: pts[torch.argsort(
            (pts[:, 0] * 1000).to(torch.int32))],
            note="argsort + row gather (the table's pattern)", n=p)
    if st.want("sort_ids"):
        st.time("sort_ids_120k", lambda: torch.sort(ids), n=v)
    if st.want("argsort160k"):
        keys = t(rng.randint(0, nz * ny * nx, p).astype(np.int32))
        vals = torch.arange(p, dtype=torch.int32, device=dev)
        st.time("argsort_160k_i32", lambda: torch.argsort(keys, stable=True),
                note="the table's stable argsort", n=p)
        st.time("sort_160k_i32_unstable", lambda: torch.sort(keys).values,
                n=p)
        st.time("sortkv_160k_i32", lambda: vals[torch.sort(keys).indices],
                note="keys and a payload", n=p)
    if st.want("sort120k"):
        keys = t(rng.randint(0, 5 * v, v).astype(np.int32))
        st.time("sort_120k_i32", lambda: torch.sort(keys).values,
                note="downsample_pillars' capped unique sort", n=v)

    # -- searchsorted over the 27 neighbours of every voxel ------------------
    offs = np.stack(np.meshgrid(*[np.arange(-1, 2)] * 3, indexing="ij"),
                    -1).reshape(27, 3)
    nb = coords[:, None, :] + offs[None]
    inb = ((nb >= 0) & (nb < np.array([nz, ny, nx]))).all(-1)
    nid = np.where(inb, (nb[..., 0] * ny + nb[..., 1]) * nx + nb[..., 2],
                   np.iinfo(np.int32).max).astype(np.int32)
    if st.want("ss_l0"):
        q = t(nid)
        st.time("ss_searchsorted_3.2M_in_120k",
                lambda: torch.searchsorted(ids, q), shape=list(nid.shape))
    if st.want("ss_9col"):
        q9 = t(nid[:, 1::3])
        st.time("ss_searchsorted_9x120k", lambda: torch.searchsorted(ids, q9),
                note="the dx = 0 taps", shape=[v, 9])

    # -- the row LUT ---------------------------------------------------------
    if st.want("lut_build_small"):
        cells = t(np.sort(rng.choice(ny * nx, npil, replace=False))
                  .astype(np.int32))
        mask = torch.ones(npil, dtype=torch.bool, device=dev)
        st.time("lut_build_64k_into_2.26M",
                lambda: pillars.build_row_lut(cells, mask, (ny, nx)),
                note="pillars.build_row_lut, per level", n=npil)
    if st.want("lut_small"):
        lut = torch.zeros(ny * nx, dtype=torch.int32, device=dev)
        lut[t(rng.choice(ny * nx, npil, replace=False))] = torch.arange(
            1, npil + 1, dtype=torch.int32, device=dev)
        q = t(rng.randint(0, ny * nx, 9 * npil))
        st.time("lut_small_450k_from_2.26M", lambda: lut[q],
                note="the row LUT's neighbour lookup", n=9 * npil)

    # -- gathers -------------------------------------------------------------
    pos = np.minimum(np.searchsorted(ids32, nid), v - 1)
    gpos = t(pos)
    f16 = t(rng.randn(v, 16).astype(np.float32))
    if st.want("gather_only"):
        st.time("gather_only_3.2Mx16", lambda: f16[gpos],
                shape=[*pos.shape, 16])
    if st.want("gather_bf16"):
        fb = f16.bfloat16()
        st.time("gather_only_bf16", lambda: fb[gpos], shape=[*pos.shape, 16])
    if st.want("gather_c128"):
        f128 = t(rng.randn(v, 128).astype(np.float32))
        st.time("gather_only_3.2Mx128", lambda: f128[gpos],
                shape=[*pos.shape, 128])
    if st.want("gather2d_flat"):
        t2 = t(rng.randn(npil, nz * 16).astype(np.float32))
        i1 = t(rng.randint(0, npil, v))
        st.time("gather2d_120k_rows_640", lambda: t2[i1],
                note="(MP, nz*C) rows, as rowpad_gather reads them",
                shape=[v, nz * 16])

    # -- segment sums and scatters -------------------------------------------
    n_slots = npil * nz
    if st.want("scatter_add_points"):
        pf = t(rng.randn(p, 5).astype(np.float32))
        slot = t(rng.randint(0, n_slots, p))
        st.time("scatter_add_160k_into_2.6M", lambda: torch.zeros(
            n_slots, 5, device=dev).index_add_(0, slot, pf), n=p)
    if st.want("seg_sum_sorted"):
        pf = t(rng.randn(p, 8).astype(np.float32))
        seg = t(np.sort(rng.randint(0, n_slots, p)))
        st.time("segsum_sorted_160k_into_2.6M",
                lambda: pillars.segment_sum_sorted(pf, seg, n_slots),
                note="pillars.segment_sum_sorted (float64 prefix sums)", n=p)
    if st.want("segsum_sorted"):
        seg = t(np.sort(rng.randint(0, v * nz, p)))
        v5 = t(rng.randn(p, 5).astype(np.float32))
        st.time("segsum_sorted_160kx5_into_4.8M",
                lambda: pillars.segment_sum_sorted(v5, seg, v * nz), n=p)
        st.time("segsum_sorted_160kx1_into_4.8M",
                lambda: pillars.segment_sum_sorted(v5[:, :1], seg, v * nz),
                n=p)
        segp = t(np.sort(rng.randint(0, v, p)))
        cells = t(rng.randint(0, ny * nx, p).astype(np.int32))
        st.time("segmin_sorted_160k_into_120k", lambda: torch.full(
            (v,), np.iinfo(np.int32).max, dtype=torch.int32,
            device=dev).scatter_reduce(0, segp, cells, "amin"),
            note="the capped unique's cells", n=p)
    if st.want("scatter_rows"):
        vf = t(rng.randn(v, 16).astype(np.float32))
        vslot = t(np.sort(rng.choice(n_slots, min(v, n_slots),
                                     replace=False)))
        st.time("scatter_rows_120kx16_into_2.6M", lambda: torch.zeros(
            n_slots, 16, device=dev).index_copy_(0, vslot, vf[:len(vslot)]),
            n=len(vslot))
    if st.want("scatter_dups"):
        cell = t(rng.randint(0, ny * nx, p))
        ones = torch.ones(p, dtype=torch.int32, device=dev)
        st.time("scatter_max_dups_160k_into_2.26M", lambda: torch.zeros(
            ny * nx, dtype=torch.int32, device=dev).scatter_reduce(
            0, cell, ones, "amax"), note="the row LUT's scatter", n=p)
        yrow = t(rng.randint(0, ny, p))
        st.time("scatter_add_dups_160k_into_1504", lambda: torch.zeros(
            ny, dtype=torch.int32, device=dev).index_add_(0, yrow, ones),
            note="rowpad_layout's row counts", n=p)
        slot = t(rng.randint(0, v * nz, p))
        v8 = t(rng.randn(p, 8).astype(np.float32))
        st.time("scatter_add_dups_160kx8_into_4.8M", lambda: torch.zeros(
            v * nz, 8, device=dev).index_add_(0, slot, v8), n=p)
    if st.want("scatter_unique"):
        nu = min(100_000, v * nz // 2)
        su = t(np.sort(rng.choice(v * nz, nu, replace=False)))
        v8 = t(rng.randn(nu, 8).astype(np.float32))
        st.time("scatter_set_unique_100kx8_into_4.8M", lambda: torch.zeros(
            v * nz, 8, device=dev).index_copy_(0, su, v8), n=nu)
        st.time("scatter_add_unique_100kx8_into_4.8M", lambda: torch.zeros(
            v * nz, 8, device=dev).index_add_(0, su, v8), n=nu)
        gidx = t(rng.randint(0, nu, v * nz))
        st.time("gather_4.8Mx8_from_100k", lambda: v8[gidx], n=v * nz)

    # -- cumsum and topk -----------------------------------------------------
    if st.want("cumsum_occ"):
        occ = t((rng.rand(ny * nx) < 0.03).astype(np.int32))
        st.time("cumsum_2.26M", lambda: torch.cumsum(occ, 0,
                                                     dtype=torch.int32),
                n=ny * nx)
    if st.want("cumsum_dense"):
        occ = t((rng.rand(ny * nx) < 0.05).astype(np.int32))
        st.time("cumsum_2.26M_i32", lambda: torch.cumsum(
            occ, 0, dtype=torch.int32), n=ny * nx)
    if st.want("topk_compact"):
        occ = t((rng.rand(ny * nx) < 0.03).astype(np.float32))
        k = min(65536, ny * nx // 2)
        st.time("topk_65536_of_2.26M", lambda: torch.topk(occ, k).indices,
                n=ny * nx, k=k)

    # -- downsampling, NMS, the BEV stack ------------------------------------
    if st.want("unique"):
        st.time("unique_capped_120k",
                lambda: pillars._unique_capped_cells(ids, v // 2)[0], n=v)
    if st.want("nms"):
        k = s["nms"]
        boxes = rng.uniform(-s["extent"], s["extent"], (k, 7))
        boxes[:, 3:6] = rng.uniform(1, 5, (k, 3))
        bx, sc = t(boxes.astype(np.float32)), t(rng.rand(k).astype(
            np.float32))
        st.time("nms_1024", lambda: nms.nms_bev(bx, sc, 0.7, k, k // 4)[0],
                note="K10 through nms_bev", n=k)
    if st.want("bev2d") or st.want("densify"):
        model = model_for("principal")
        h, w = model.bev_hw
        c = _bev_channels(model)
    if st.want("bev2d"):
        bev = torch.randn((1, h, w, c), generator=torch.Generator(
            ).manual_seed(2)).to(dev, model.dtype)
        with torch.no_grad():
            st.time("bev2d_head_dense", lambda: model.bev_head(bev),
                    note="BaseBEVBackbone + CenterHead, eval", shape=[h, w, c])
    if st.want("densify"):
        n = min(15_000, h * w // 2)
        cells = t(np.sort(rng.choice(h * w, n, replace=False)).astype(
            np.int32))
        mask = torch.ones(n, dtype=torch.bool, device=dev)
        f = t(rng.randn(n, c).astype(np.float32))
        st.time("densify_final_bev",
                lambda: pillars.densify_pillars(f, cells, mask, (h, w)),
                n=n, shape=[h, w, c])

    # -- the row-pad kernels on random maps ----------------------------------
    def conv(name, key, lvl, kernel):
        if not st.want(key):
            return
        g = plan_level_sizes(s, lvl)
        r = np.random.RandomState(5 + lvl)
        nzl, nyl, cin = g["nz"], g["ny"], g["c"]
        if kernel == "down":
            o = plan_level_sizes(s, lvl + 1)
            tab, _ = rowpad_fixture(nyl, b, nzl, cin, dev, r)
            _, nbr = rowpad_fixture(o["ny"], b, nzl, cin, dev, r)
            zm = torch.from_numpy(r.rand(o["ny"], o["nz"], b) < 0.5).to(dev)
            w = torch.from_numpy(r.randn(27, cin, o["c"]).astype(
                np.float32) * 0.05).to(dev, torch.bfloat16)
            kw = dict(nz=nzl, cin=cin, cout=o["c"], z_stride=2,
                      out_nz=o["nz"], mode="down")
            st.time(name, lambda: rowpad_conv.rowpad_conv(
                tab, nbr, w, zm, **kw), note="K4 'down'",
                shape=[nyl, nzl * cin, b])
            return
        tab, nbr = rowpad_fixture(nyl, b, nzl, cin, dev, r)
        zm = torch.from_numpy(r.rand(nyl, nzl, b) < 0.5).to(dev)
        w = torch.from_numpy(r.randn(27, cin, cin).astype(np.float32)
                             * 0.05).to(dev, torch.bfloat16)
        kw = dict(nz=nzl, cin=cin, cout=cin)
        shape = [nyl, nzl * cin, b]
        if kernel == "K4":
            fn = lambda: rowpad_conv.rowpad_conv(tab, nbr, w, zm, **kw)
        elif kernel == "K9":
            fn = lambda: rowpad_conv.rowpad_conv_sliding(tab, nbr, w, zm,
                                                         **kw)
        elif kernel == "K2":
            sc = torch.ones(cin, device=dev)
            bi = torch.zeros(cin, device=dev)
            fn = lambda: rowpad_conv.rowpad_conv_fused(  # noqa: E731
                tab, nbr, w.float(), sc, bi, zm, None, **kw)
        else:
            ct = tab.clone()
            fn = lambda: rowpad_conv.rowpad_conv_dw(tab, nbr, ct, zm, **kw)
        st.time(name, fn, note=kernel, shape=shape)

    conv("pallas_conv_l0_rowpad", "pallas_conv_l0", 0, "K4")
    conv("pallas_conv_l0_sliding", "pallas_conv_l0_sliding", 0, "K9")
    conv("pallas_conv_l0_fusedbn", "pallas_conv_l0_fusedbn", 0, "K2")
    conv("pallas_conv_l0_down", "pallas_conv_l0_down", 0, "down")
    conv("pallas_conv_l1_rowpad", "pallas_conv_l1", 1, "K4")
    conv("pallas_conv_l3_rowpad", "pallas_conv_l3", 3, "K4")
    conv("pallas_dw_l0", "pallas_dw_l0", 0, "K5")


def plan_level_sizes(s, lvl):
    """Rows, z planes and channels of level `lvl` of the flagship's plan."""
    nz, ny, _ = s["grid"]
    for _ in range(lvl):
        nz, ny = -(-nz // 2), -(-ny // 2)
    return {"nz": nz, "ny": ny, "c": 16 << lvl}


def _bev_channels(model):
    from detzero_tpu_torch.models.detection.backbone3d_pillar import (
        plan_grids,
    )

    return model.backbone3d.channels[3] * plan_grids(model.grid_zyx)[4][0]


# ---------------------------------------------------------------------------
# prefix and fusegap
# ---------------------------------------------------------------------------

def frame(scale, device):
    """entry()'s points (the tiny scale: 2048 of them, squeezed into the
    tiny range as chip_smoke's tiny check does), on `device`."""
    cs = chip_smoke()
    s = SCALES[scale]
    pts, pv = cs.entry_points(s["points"])
    if scale == "tiny":
        pts[..., :2] *= 6.0 / 70.0
        pts[..., 2] = np.clip(pts[..., 2], -1.8, 1.8)
    return (torch.from_numpy(pts[0]).to(device),
            torch.from_numpy(pv[0]).to(device))


def model_factory(scale, device):
    """site mode -> the flagship (bf16 on the card) or the tiny model, with
    seeded weights, built once a mode."""
    cs = chip_smoke()
    cfg, kw = ((cs.FLAGSHIP_CFG, cs.FLAGSHIP_KW) if scale == "full"
               else (cs.TINY_CFG, cs.TINY_KW))
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    built = {}

    def get(mode):
        if mode not in built:
            built[mode] = cs.build_model(
                dict(cfg, DOWNSAMPLE_SITE_MODE=mode), kw, dtype, device)
        return built[mode]

    return get


def run_prefix(st, model_for):
    p, v = frame(st.scale, st.device)
    for mode in SITE_MODES:
        model = model_for(mode)
        with torch.no_grad():
            if st.want("voxelize"):
                st.time("prefix_voxelize", lambda: model.build_table(p, v),
                        site_mode=mode)
            if st.want("tables"):
                st.time("prefix_tables(voxelize+plan)",
                        lambda: model.prepare(p[None], v[None]),
                        note="table, K1, plan and K8", site_mode=mode)
            if st.want("backbone"):
                rp, plan = model.prepare(p[None], v[None])
                st.time("prefix_backbone+head(prebuilt_plan)",
                        lambda: model.network(rp, plan), site_mode=mode)
                del rp, plan
            if st.want("forward"):
                st.time("prefix_forward", lambda: model.forward_one(p, v),
                        site_mode=mode)
        if st.want("predict"):
            st.time("prefix_predict(+decode+nms)",
                    lambda: model.predict(p[None], v[None]), site_mode=mode)


def run_fusegap(st, model_for):
    from detzero_tpu_torch.models.detection.backbone3d_pallas import (
        augment_plan_rowpad,
    )
    from detzero_tpu_torch.models.detection.backbone3d_pillar import (
        build_pillar_plan,
    )

    p, v = frame(st.scale, st.device)
    for mode in SITE_MODES:
        model = model_for(mode)
        with torch.no_grad():
            table = model.build_table(p, v)
            if st.want("fg_tables"):
                st.time("fg_tables", lambda: model.prepare(p[None], v[None]),
                        site_mode=mode)
            if st.want("fg_vox_table"):
                st.time("fg_vox_table", lambda: model.build_table(p, v),
                        note="build_table only (sort + segments)",
                        site_mode=mode)
            base = build_pillar_plan(table, model.grid_zyx,
                                     model.pillar_capacities, site_mode=mode,
                                     with_centroids=model.second_stage)
            if st.want("fg_vox_baseplan"):
                st.time("fg_vox_baseplan", lambda: build_pillar_plan(
                    table, model.grid_zyx, model.pillar_capacities,
                    site_mode=mode, with_centroids=model.second_stage),
                    note="build_pillar_plan from a prebuilt table",
                    site_mode=mode)
            if st.want("fg_vox_rowpad"):
                st.time("fg_vox_rowpad", lambda: augment_plan_rowpad(
                    base, model.grid_zyx, model.row_budget),
                    note="augment_plan_rowpad (K8) from a prebuilt base plan",
                    site_mode=mode)
            rp, plan = model.prepare(p[None], v[None])
            if st.want("fg_net_arg"):
                st.time("fg_net_arg", lambda: model.network(rp, plan),
                        note="the network on a prebuilt plan", site_mode=mode)
            if st.want("fg_forward"):
                st.time("fg_forward", lambda: model.network(
                    *model.prepare(p[None], v[None])), site_mode=mode)
            if st.want("fg_levels"):
                backbone_levels(st, model, rp, plan, mode)
        del table, base, rp, plan


def backbone_levels(st, model, rp, plan, mode):
    """The 3D backbone from its input to the end of level l (the start of
    level l's down conv, of the z conv after level 3) and to its output,
    marked inside one forward by pre-hooks."""
    bb = model.backbone3d
    marks = []
    cuda = st.device.type == "cuda"

    def hook(name):
        def pre(*_):
            if cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append((name, ev))
            else:
                marks.append((name, time.perf_counter()))
        return pre

    ends = [*bb.downs, bb.zconv]
    handles = [getattr(bb, n).register_forward_pre_hook(hook(f"L{lvl}"))
               for lvl, n in enumerate(ends)]
    try:
        total, pieces = st._host_paced(lambda: bb(rp, plan), marks)
        if cuda:
            # the same marks with the calls queued behind a spin kernel, so
            # that the events read the card's time
            cs = chip_smoke()
            t0 = time.perf_counter()
            bb(rp, plan)
            torch.cuda.synchronize()
            torch.cuda._sleep(int(cs.CARD_HZ * 1.5 * st.iters
                                  * (time.perf_counter() - t0)) + 10_000)
            card_total, card = st._host_paced(lambda: bb(rp, plan), marks)
        else:
            card_total, card = total, pieces
    finally:
        for h in handles:
            h.remove()
    for lvl in range(4):
        st.record(f"fg_backbone_l{lvl}", card[f"L{lvl}"], pieces[f"L{lvl}"],
                  note=f"3D backbone input to the end of level {lvl}",
                  site_mode=mode)
    st.record("fg_backbone", card_total, total,
              note="the whole 3D backbone (z conv and densify included)",
              site_mode=mode)


GROUPS = {"micro": run_micro, "prefix": run_prefix, "fusegap": run_fusegap}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("groups", nargs="*", default=["micro"],
                        choices=sorted(GROUPS))
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--scale", default="full", choices=sorted(SCALES))
    parser.add_argument("--iters", type=int,
                        default=int(os.environ.get("BISECT_ITER", "5")))
    parser.add_argument("--output", default=str(OUTPUT))
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to time the "
                           "plain versions on the CPU")
    only = os.environ.get("BISECT_ONLY")
    only = set(only.split(",")) if only else None
    head = {"device": str(device), "groups": args.groups,
            "scale": args.scale}
    if device.type == "cuda":
        head.update(kind=torch.cuda.get_device_name(device),
                    card=chip_smoke().nvidia_smi_line())
    print(json.dumps(head), flush=True)
    results = []
    model_for = model_factory(args.scale, device)
    for grp in args.groups:
        GROUPS[grp](Stages(grp, device, args.scale, args.iters, results,
                           only), model_for)
    out = Path(args.output)
    out.parent.mkdir(parents=True, exist_ok=True)
    existing = json.loads(out.read_text()) if out.exists() else []
    out.write_text(json.dumps(existing + results, indent=1))
    return results


if __name__ == "__main__":
    main()
