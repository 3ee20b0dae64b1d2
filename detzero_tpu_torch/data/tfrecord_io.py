"""TFRecord container I/O without TensorFlow (port of
detzero_tpu/data/tfrecord_io.py).

Record framing (the TFRecord on-disk format):
    uint64 length | uint32 masked_crc32c(length) | bytes data |
    uint32 masked_crc32c(data)
with crc32c masked as ((crc >> 15 | crc << 17) + 0xa282ead8) mod 2^32.

The checksum is the native library's (`native.masked_crc32c`, built with
g++ at first use), and only that: where it cannot be built, reading with
`verify_crc=True` and writing raise.  A byte loop in Python would cost
seconds for each megabyte-sized Waymo frame.
"""

from __future__ import annotations

import struct

from detzero_tpu_torch import native


def write_tfrecord(path, records):
    """records: iterable of bytes."""
    with open(path, "wb") as f:
        for rec in records:
            hdr = struct.pack("<Q", len(rec))
            f.write(hdr)
            f.write(struct.pack("<I", native.masked_crc32c(hdr)))
            f.write(rec)
            f.write(struct.pack("<I", native.masked_crc32c(rec)))


def read_tfrecord(path, verify_crc: bool = False):
    """Yields record bytes."""
    with open(path, "rb") as f:
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                return
            (length,) = struct.unpack("<Q", hdr)
            hcrc_b = f.read(4)
            data = f.read(length)
            dcrc_b = f.read(4)
            if len(hcrc_b) < 4 or len(data) < length or len(dcrc_b) < 4:
                raise IOError("truncated tfrecord")
            (hcrc,) = struct.unpack("<I", hcrc_b)
            (dcrc,) = struct.unpack("<I", dcrc_b)
            if verify_crc and (native.masked_crc32c(hdr) != hcrc
                               or native.masked_crc32c(data) != dcrc):
                raise IOError("tfrecord crc mismatch")
            yield data
