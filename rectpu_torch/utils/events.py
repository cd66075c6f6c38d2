"""TensorBoard event files without TensorFlow: the port of ``rectpu/utils/events.py``.

TensorFlow's Event and Summary protos are encoded by hand (protobuf wire
format) into TFRecord-framed ``events.out.tfevents.*`` files with masked
CRC32C checksums, which TensorBoard reads as they are. Scalars and
histograms (TF's exponential bucket limits, +-1e-12 * 1.1^k) are the two
summary kinds the trainers write: the loss, examples/s and eval metrics,
and each parameter's histogram with its share of zeros (``train/loop.py``).
For the same calls and wall times the records are rectpu's byte for byte.
numpy only.
"""

from __future__ import annotations

import struct
import time
from pathlib import Path

import numpy as np

# --- crc32c (Castagnoli), table-based ----------------------------------------

def _crc_table() -> tuple:
    poly = 0x82F63B78
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    return tuple(table)


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --- protobuf wire encoding ---------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_double(field: int, value: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", value)


def _f_float(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", value)


def _f_varint(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value)


def _f_bytes(field: int, value: bytes) -> bytes:
    return _key(field, 2) + _varint(len(value)) + value


def _f_packed_doubles(field: int, values) -> bytes:
    payload = b"".join(struct.pack("<d", float(v)) for v in values)
    return _f_bytes(field, payload)


def _summary_value_scalar(tag: str, value: float) -> bytes:
    # Summary.Value: tag=1 (string), simple_value=2 (float)
    return _f_bytes(1, tag.encode()) + _f_float(2, float(value))


def _histogram_proto(values: np.ndarray) -> bytes:
    """HistogramProto with TF's exponential bucket boundaries."""
    values = np.asarray(values, dtype=np.float64).ravel()
    if values.size == 0:
        values = np.zeros(1)
    # TF-style bucket limits: +-1e-12 * 1.1^k geometric grid
    limits = [1e-12]
    while limits[-1] < 1e20:
        limits.append(limits[-1] * 1.1)
    limits = np.array([-x for x in reversed(limits)] + [0.0] + limits)
    counts, _ = np.histogram(values, bins=np.concatenate([[-np.inf], limits]))
    nz = counts.nonzero()[0]
    if nz.size:
        lo, hi = nz[0], nz[-1] + 1
    else:
        lo, hi = 0, 1
    msg = (
        _f_double(1, float(values.min()))
        + _f_double(2, float(values.max()))
        + _f_double(3, float(values.size))
        + _f_double(4, float(values.sum()))
        + _f_double(5, float((values**2).sum()))
        + _f_packed_doubles(6, limits[lo:hi])
        + _f_packed_doubles(7, counts[lo:hi])
    )
    return msg


def _summary_value_histo(tag: str, values: np.ndarray) -> bytes:
    return _f_bytes(1, tag.encode()) + _f_bytes(5, _histogram_proto(values))


def _event(wall_time: float, step: int | None = None, summary: bytes | None = None,
           file_version: str | None = None) -> bytes:
    # Event: wall_time=1 (double), step=2 (int64), file_version=3, summary=5
    msg = _f_double(1, wall_time)
    if step is not None:
        msg += _f_varint(2, step)
    if file_version is not None:
        msg += _f_bytes(3, file_version.encode())
    if summary is not None:
        msg += _f_bytes(5, summary)
    return msg


class EventWriter:
    """Append-only TensorBoard event file under ``logdir``."""

    def __init__(self, logdir: str | Path):
        self.logdir = Path(logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.rectpu"
        self._f = (self.logdir / fname).open("ab")
        self._write_record(_event(time.time(), file_version="brain.Event:2"))

    def _write_record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _masked_crc(data)))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write_record(
            _event(time.time(), step=step, summary=summary_wrap(_summary_value_scalar(tag, value)))
        )

    def add_scalars(self, scalars: dict, step: int) -> None:
        summary = b"".join(
            _f_bytes(1, _summary_value_scalar(tag, v)) for tag, v in scalars.items()
        )
        self._write_record(_event(time.time(), step=step, summary=summary))

    def add_histogram(self, tag: str, values, step: int) -> None:
        summary = _f_bytes(1, _summary_value_histo(tag, np.asarray(values)))
        self._write_record(_event(time.time(), step=step, summary=summary))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.flush()
        self._f.close()


def summary_wrap(value_msg: bytes) -> bytes:
    """Wrap a single Summary.Value message into a Summary message."""
    return _f_bytes(1, value_msg)


# --- reading back -------------------------------------------------------------


def _fields(msg: bytes):
    """(field number, value) of each field of a protobuf message: varints as
    ints, the other wire types as their bytes."""
    pos = 0

    def varint():
        nonlocal pos
        shift = value = 0
        while True:
            b = msg[pos]
            pos += 1
            value |= (b & 0x7F) << shift
            shift += 7
            if b < 0x80:
                return value

    while pos < len(msg):
        key = varint()
        field, wire = key >> 3, key & 7
        if wire == 0:
            yield field, varint()
            continue
        n = varint() if wire == 2 else (8 if wire == 1 else 4)
        yield field, msg[pos:pos + n]
        pos += n


def read_events(path: str | Path) -> list:
    """(step, [tags]) of every summary record of an event file, in file order;
    raises ValueError on a record whose length or data fails its CRC."""
    data = Path(path).read_bytes()
    out, pos = [], 0
    while pos < len(data):
        header = data[pos:pos + 8]
        (n,) = struct.unpack("<Q", header)
        rec = data[pos + 12:pos + 12 + n]
        crcs = struct.unpack("<II", data[pos + 8:pos + 12] + data[pos + 12 + n:pos + 16 + n])
        if crcs != (_masked_crc(header), _masked_crc(rec)):
            raise ValueError(f"{path}: bad CRC in the record at byte {pos}")
        pos += 16 + n
        fields = dict(_fields(rec))
        if 5 in fields:  # Event.summary: Summary.value (1) -> Value.tag (1)
            tags = [dict(_fields(v))[1].decode() for f, v in _fields(fields[5]) if f == 1]
            out.append((fields.get(2, 0), tags))
    return out
