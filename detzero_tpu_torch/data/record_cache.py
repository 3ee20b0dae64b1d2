"""Columnar, mmap-backed object-record cache for the refining stage (port
of detzero_tpu/data/record_cache.py: the same `DZRC0001` file format, so
either package reads a cache that the other wrote).

The reference loads EVERY per-sequence object pickle into RAM before
refining training starts (refining/detzero_refine/datasets/dataset.py:64
``load_track_infos`` — its README explicitly recommends A100-class hosts
for the RAM). This module replaces that with a single flat file per class:

    MAGIC 'DZRC0001' | uint64 header_len | header JSON | 64-byte-aligned blob

Array fields live in the blob and are served as **zero-copy views into one
``np.memmap``** — records materialize lazily on access, so training touches
only the pages it samples and host RSS stays flat regardless of dataset
size. Ragged per-frame point lists are stored flattened with a row-splits
vector and rebuilt as views. Non-array metadata (strings, scalars, poses as
nested lists) rides in the JSON header.

Writer: :func:`write_record_cache`; reader: :class:`RecordCache`;
:class:`RecordListView` adapts one or more caches (plus repeat factors) to
the list-of-dicts interface the refining datasets consume.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

MAGIC = b"DZRC0001"
_ALIGN = 64


def _pad(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def write_record_cache(path, records: dict) -> None:
    """records: {key: {field: value}} where values are np arrays, lists of
    per-frame arrays (ragged -> flattened + row_splits), or JSON-able
    metadata."""
    header = {"records": {}, "version": 1}
    blobs = []
    offset = 0

    def put(arr):
        nonlocal offset
        arr = np.ascontiguousarray(arr)
        entry = {"dtype": arr.dtype.str, "shape": list(arr.shape),
                 "offset": offset}
        pad_to = _pad(arr.nbytes)
        blobs.append(arr.tobytes() + b"\0" * (pad_to - arr.nbytes))
        offset += pad_to
        return entry

    for key, rec in records.items():
        fields = {}
        for name, val in rec.items():
            if isinstance(val, np.ndarray) and val.dtype != object:
                fields[name] = {"array": put(val)}
            elif (isinstance(val, (list, tuple)) and len(val)
                  and all(isinstance(v, np.ndarray) and v.ndim == 2
                          for v in val)):
                widths = {v.shape[1] for v in val}
                if len(widths) == 1:  # ragged list of (Ni, F) arrays
                    splits = np.cumsum([0] + [len(v) for v in val]).astype(
                        np.int64)
                    flat = (np.concatenate(val) if splits[-1] else
                            np.zeros((0, widths.pop()), np.float32))
                    fields[name] = {"ragged": put(flat),
                                    "splits": put(splits)}
                    continue
                fields[name] = {"json": [v.tolist() for v in val]}
            elif isinstance(val, np.ndarray):  # object arrays -> JSON
                fields[name] = {"json": val.tolist()}
            elif isinstance(val, (np.generic,)):
                fields[name] = {"json": val.item()}
            else:
                try:
                    json.dumps(val)
                    fields[name] = {"json": val}
                except TypeError:
                    fields[name] = {"json": np.asarray(val).tolist()}
        header["records"][str(key)] = fields

    hj = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(np.uint64(len(hj)).tobytes())
        f.write(hj)
        pad = _pad(f.tell()) - f.tell()
        f.write(b"\0" * pad)
        for b in blobs:
            f.write(b)


class RecordCache:
    """Lazy reader: ``cache[key]`` / ``cache.at(i)`` materialize one record
    as a dict whose arrays are views into the shared memmap."""

    def __init__(self, path):
        self.path = Path(path)
        with open(self.path, "rb") as f:
            if f.read(len(MAGIC)) != MAGIC:
                raise ValueError(f"{path}: not a DZRC cache")
            hlen = int(np.frombuffer(f.read(8), np.uint64)[0])
            header = json.loads(f.read(hlen).decode())
            self._blob_start = _pad(f.tell())
        self._records = header["records"]
        self.keys = list(self._records)
        self._mm = np.memmap(self.path, mode="r", offset=self._blob_start)

    def _get_array(self, entry):
        dt = np.dtype(entry["dtype"])
        shape = tuple(entry["shape"])
        n = int(np.prod(shape)) * dt.itemsize
        raw = self._mm[entry["offset"]: entry["offset"] + n]
        return raw.view(dt).reshape(shape)

    def materialize(self, key):
        fields = self._records[key]
        out = {}
        for name, spec in fields.items():
            if "array" in spec:
                out[name] = self._get_array(spec["array"])
            elif "ragged" in spec:
                flat = self._get_array(spec["ragged"])
                splits = self._get_array(spec["splits"])
                out[name] = [flat[splits[i]: splits[i + 1]]
                             for i in range(len(splits) - 1)]
            else:
                out[name] = spec["json"]
        return out

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, key):
        return self.materialize(key)

    def at(self, i: int):
        return self.materialize(self.keys[i])


class RecordListView:
    """List-of-dicts facade over (cache, key) pairs — what
    RefineDatasetBase consumes; supports class-balance repetition without
    copying (cyclists x50, reference dataset.py:160-163)."""

    def __init__(self, caches):
        self._idx = []
        for c in caches:
            seq = c.path.stem
            for k in c.keys:
                self._idx.append((c, seq, k))

    def __len__(self):
        return len(self._idx)

    def __getitem__(self, i):
        c, seq, k = self._idx[i]
        rec = c.materialize(k)
        rec["_key"] = (seq, k)
        return rec

    def __mul__(self, n: int):
        out = RecordListView([])
        out._idx = self._idx * n
        return out

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
