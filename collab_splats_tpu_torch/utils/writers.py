"""Metric sinks: JSONL, TensorBoard event files, and wandb (gated).

Counterpart of the JAX package's ``utils/writers.py``, an own copy (the
module needs neither framework).  The reference exposes nerfstudio's
``--vis`` options (viewer / wandb / tensorboard); here:

* :class:`JsonlWriter`: one JSON object per logged step; the
  no-dependency default.
* :class:`TensorboardWriter`: genuine tfevents files (the scalar-summary
  subset of the format: protobuf-free hand-encoded Event records with
  masked CRC32C framing), readable by TensorBoard.
* :class:`WandbWriter`: forwards to ``wandb`` when importable, else raises
  at construction.

All writers share ``write(step, metrics: dict) / close()``;
``Trainer(writers=...)`` writes each step's metrics to every one.
"""


from __future__ import annotations

import json
import os
import struct
import time
from pathlib import Path
from typing import Dict, List, Optional

# ------------------------------------------------------------------ crc32c

_CRC_TABLE = []


def _crc32c_table():
    global _CRC_TABLE
    if _CRC_TABLE:
        return _CRC_TABLE
    poly = 0x82F63B78
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        table.append(crc)
    _CRC_TABLE = table
    return table


def _crc32c(data: bytes) -> int:
    table = _crc32c_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# --------------------------------------------------- minimal proto encoding


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b7 | 0x80])
        else:
            out += bytes([b7])
            return out


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _len_delim(num: int, payload: bytes) -> bytes:
    return _field(num, 2) + _varint(len(payload)) + payload


def _float_field(num: int, value: float) -> bytes:
    return _field(num, 5) + struct.pack("<f", value)


def _double_field(num: int, value: float) -> bytes:
    return _field(num, 1) + struct.pack("<d", value)


def _int_field(num: int, value: int) -> bytes:
    return _field(num, 0) + _varint(value)


def _scalar_event(step: int, tag: str, value: float, wall: float) -> bytes:
    # Summary.Value { tag=1: string, simple_value=2: float }
    sv = _len_delim(1, tag.encode()) + _float_field(2, float(value))
    # Summary { value=1: repeated Value }
    summary = _len_delim(1, sv)
    # Event { wall_time=1: double, step=2: int64, summary=5: Summary }
    return _double_field(1, wall) + _int_field(2, step) + _len_delim(5, summary)


def _record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (
        header
        + struct.pack("<I", _masked_crc(header))
        + payload
        + struct.pack("<I", _masked_crc(payload))
    )


# ----------------------------------------------------------------- writers


class JsonlWriter:
    def __init__(self, log_dir: str | Path, filename: str = "metrics.jsonl"):
        self.path = Path(log_dir) / filename
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a")

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class TensorboardWriter:
    """Scalar-only tfevents writer (no tensorflow/tensorboard dependency)."""

    def __init__(self, log_dir: str | Path):
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        host = os.uname().nodename
        self.path = Path(log_dir) / (
            f"events.out.tfevents.{int(time.time())}.{host}"
        )
        self._f = open(self.path, "ab")
        # File-version header event.
        ver = _double_field(1, time.time()) + _len_delim(
            3, b"brain.Event:2"
        )
        self._f.write(_record(ver))

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        wall = time.time()
        for tag, value in metrics.items():
            self._f.write(_record(_scalar_event(step, tag, value, wall)))
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class WandbWriter:
    def __init__(self, project: str = "collab-splats-tpu", **kwargs):
        import wandb  # gated: raises ImportError where not installed

        self._run = wandb.init(project=project, **kwargs)

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        self._run.log({k: float(v) for k, v in metrics.items()}, step=step)

    def close(self) -> None:
        self._run.finish()


def make_writers(vis: str, log_dir: str | Path) -> List:
    """nerfstudio-style ``--vis`` selector: comma-separated subset of
    {jsonl, tensorboard, wandb}."""
    out: List = []
    for kind in [v.strip() for v in vis.split(",") if v.strip()]:
        if kind == "jsonl":
            out.append(JsonlWriter(log_dir))
        elif kind == "tensorboard":
            out.append(TensorboardWriter(log_dir))
        elif kind == "wandb":
            out.append(WandbWriter())
        elif kind in ("viewer", "none"):
            continue
        else:
            raise ValueError(f"unknown vis sink {kind!r}")
    return out


# ----------------------------------------------------- tfevents round trip


def read_tfevents_scalars(path: str | Path):
    """Parse scalar events back out of a tfevents file (validation and
    tests; also a convenience for plotting without tensorboard)."""
    data = Path(path).read_bytes()
    off = 0
    out = []
    while off < len(data):
        (length,) = struct.unpack_from("<Q", data, off)
        payload = data[off + 12 : off + 12 + length]
        off += 12 + length + 4
        out.extend(_parse_event(payload))
    return out


def _parse_event(buf: bytes):
    step, wall, scalars = 0, 0.0, []
    off = 0
    while off < len(buf):
        key, off = _read_varint(buf, off)
        num, wire = key >> 3, key & 7
        if wire == 0:
            val, off = _read_varint(buf, off)
            if num == 2:
                step = val
        elif wire == 1:
            (val,) = struct.unpack_from("<d", buf, off)
            off += 8
            if num == 1:
                wall = val
        elif wire == 5:
            off += 4
        elif wire == 2:
            ln, off = _read_varint(buf, off)
            sub = buf[off : off + ln]
            off += ln
            if num == 5:  # summary
                scalars.extend(_parse_summary(sub))
    return [
        {"step": step, "wall_time": wall, "tag": t, "value": v}
        for t, v in scalars
    ]


def _parse_summary(buf: bytes):
    out = []
    off = 0
    while off < len(buf):
        key, off = _read_varint(buf, off)
        num, wire = key >> 3, key & 7
        if wire == 2:
            ln, off = _read_varint(buf, off)
            sub = buf[off : off + ln]
            off += ln
            if num == 1:
                tag, value = None, None
                o2 = 0
                while o2 < len(sub):
                    k2, o2 = _read_varint(sub, o2)
                    n2, w2 = k2 >> 3, k2 & 7
                    if w2 == 2:
                        ln2, o2 = _read_varint(sub, o2)
                        if n2 == 1:
                            tag = sub[o2 : o2 + ln2].decode()
                        o2 += ln2
                    elif w2 == 5:
                        if n2 == 2:
                            (value,) = struct.unpack_from("<f", sub, o2)
                        o2 += 4
                    elif w2 == 0:
                        _, o2 = _read_varint(sub, o2)
                    elif w2 == 1:
                        o2 += 8
                if tag is not None and value is not None:
                    out.append((tag, value))
        elif wire == 0:
            _, off = _read_varint(buf, off)
        elif wire == 1:
            off += 8
        elif wire == 5:
            off += 4
    return out


def _read_varint(buf: bytes, off: int):
    result = 0
    shift = 0
    while True:
        b = buf[off]
        off += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, off
        shift += 7
