"""Convert daemon per-sequence object pickles into mmap record caches (port
of tools/build_record_cache.py; the same DZRC0001 files).

Pickles stay the inter-stage artifact (reference-compatible schema); the
.dzrc cache is the training-time layout — refining datasets pick it up
automatically when present (data/refine_dataset.py) and stop loading the
whole class into RAM (the reference's load_track_infos behavior,
refining/detzero_refine/datasets/dataset.py:64).

Usage:
    python -m detzero_tpu_torch.tools.build_record_cache \
        --object_root data/waymo/refining \
        [--classes Vehicle Pedestrian Cyclist] [--delete_pickles]

`main(argv)` runs in-process and returns {class name: records cached}.
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path


def _verify_cache_contents(pkl_path, seq, back, sample: int = 8):
    """Deep-compare source records against the re-read cache before the
    source pickle may be unlinked: field-key sets for every record, exact
    array equality for a sample (a silent writer field-encoding regression
    must not destroy the inter-stage artifact)."""
    import numpy as np

    keys = list(seq)
    for k in keys:
        src_fields = set(seq[k].keys())
        dst_fields = set(back[str(k)].keys())  # JSON header keys are str
        assert src_fields == dst_fields, (
            f"{pkl_path}[{k}]: field mismatch {src_fields ^ dst_fields}")
    step = max(1, len(keys) // sample)
    for k in keys[::step]:
        src, dst = seq[k], back[str(k)]
        for name, val in src.items():
            got = dst[name]
            if isinstance(val, np.ndarray) and val.dtype != object:
                assert np.array_equal(np.asarray(got), val), (
                    f"{pkl_path}[{k}].{name}: array mismatch")
            elif (isinstance(val, (list, tuple)) and len(val)
                  and all(isinstance(v, np.ndarray) for v in val)):
                assert len(got) == len(val), f"{pkl_path}[{k}].{name}: length"
                for a, b in zip(val, got):
                    assert np.allclose(np.asarray(b, np.float64),
                                       np.asarray(a, np.float64)), (
                        f"{pkl_path}[{k}].{name}: ragged mismatch")


def main(argv=None):
    from detzero_tpu_torch.data.record_cache import (
        RecordCache, write_record_cache,
    )

    ap = argparse.ArgumentParser("pickle -> dzrc record cache")
    ap.add_argument("--object_root", required=True)
    ap.add_argument("--classes", nargs="+",
                    default=["Vehicle", "Pedestrian", "Cyclist"])
    ap.add_argument("--delete_pickles", action="store_true",
                    help="remove source pickles after a verified conversion")
    args = ap.parse_args(argv)
    cached = {}

    for cls in args.classes:
        cls_dir = Path(args.object_root) / cls
        if not cls_dir.exists():
            print(f"{cls}: no directory, skipped")
            continue
        n_total = 0
        for p in sorted(cls_dir.glob("*.pkl")):
            with open(p, "rb") as f:
                seq = pickle.load(f)
            out = p.with_suffix(".dzrc")
            write_record_cache(out, seq)
            back = RecordCache(out)
            assert len(back) == len(seq), (p, len(back), len(seq))
            _verify_cache_contents(p, seq, back)
            n_total += len(seq)
            if args.delete_pickles:
                p.unlink()
        print(f"{cls}: {n_total} records cached")
        cached[cls] = n_total
    return cached


if __name__ == "__main__":
    main()
