"""TensorBoard scalar writer and reader, standard library only.

A copy of dostransformer_tpu/train/tensorboard.py (the port imports nothing
of the JAX package), so a file either framework writes is read by the
other's :func:`read_events`. Neither tensorboard nor tensorflow is needed:
a TensorBoard run is a TFRecord stream of serialized ``tensorflow.Event``
protos, and the subset scalar curves need (wall_time / step /
Summary{tag, simple_value}) is encoded by hand.

Wire formats:
  * TFRecord framing: [len u64le][masked crc32c(len) u32le][payload]
    [masked crc32c(payload) u32le], mask(c) = ((c>>15 | c<<17) + 0xa282ead8).
  * protobuf wire encoding of Event fields 1 (double wall_time),
    2 (varint step), 3 (file_version string) and 5 (Summary message with
    repeated Value{tag=1:string, simple_value=2:float}).
"""

from __future__ import annotations

import os
import socket
import struct
import time


# -- crc32c (Castagnoli), table-driven -------------------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = _crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- minimal protobuf wire encoding ----------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delimited(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int | None = None,
           file_version: str | None = None,
           scalars: dict | None = None) -> bytes:
    msg = _key(1, 1) + struct.pack("<d", wall_time)
    if step is not None:
        msg += _key(2, 0) + _varint(step)
    if file_version is not None:
        msg += _len_delimited(3, file_version.encode())
    if scalars:
        summary = b""
        for tag, value in scalars.items():
            val = (_len_delimited(1, tag.encode())
                   + _key(2, 5) + struct.pack("<f", float(value)))
            summary += _len_delimited(1, val)
        msg += _len_delimited(5, summary)
    return msg


def _record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header))
            + payload + struct.pack("<I", _masked_crc(payload)))


class SummaryWriter:
    """Append scalar curves to a TensorBoard event file under `logdir`."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        # pid suffix: two runs started into the same logdir within the same
        # second must get DISTINCT files (TensorBoard's own writers suffix a
        # uid for the same reason); "wb" not "ab" since the name is unique
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}.{os.getpid()}")
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "wb")
        self._f.write(_record(_event(time.time(),
                                     file_version="brain.Event:2")))
        self._f.flush()

    def add_scalars(self, step: int, scalars: dict) -> None:
        """Write {tag: value} at `step` (one Event, many Summary.Values).
        Flushed per call — eval-cadence writes are rare, and a crash mid-run
        must not lose the curves recorded so far."""
        self._f.write(_record(_event(time.time(), step=step,
                                     scalars=scalars)))
        self._f.flush()

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()


def read_events(path: str):
    """Parse an event file back into (step, {tag: value}) tuples — the
    inverse of SummaryWriter for round-trip tests (and offline inspection
    without TensorBoard installed)."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        (length,) = struct.unpack_from("<Q", data, pos)
        (len_crc,) = struct.unpack_from("<I", data, pos + 8)
        if len_crc != _masked_crc(data[pos:pos + 8]):
            raise ValueError(f"{path}: bad length crc at byte {pos}")
        payload = data[pos + 12:pos + 12 + length]
        (pay_crc,) = struct.unpack_from("<I", data, pos + 12 + length)
        if pay_crc != _masked_crc(payload):
            raise ValueError(f"{path}: bad payload crc at byte {pos}")
        pos += 12 + length + 4
        out.append(_parse_event(payload))
    return out


def _read_varint(buf: bytes, pos: int):
    n = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, pos
        shift += 7


def _parse_event(buf: bytes):
    step, scalars = None, {}
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 1:
            value = struct.unpack_from("<d", buf, pos)[0]
            pos += 8
        elif wire == 5:
            value = struct.unpack_from("<f", buf, pos)[0]
            pos += 4
        elif wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            value = buf[pos:pos + ln]
            pos += ln
        else:
            raise ValueError(f"wire type {wire}")
        if field == 2:
            step = value
        elif field == 5:
            spos = 0
            while spos < len(value):
                skey, spos = _read_varint(value, spos)
                if skey >> 3 != 1 or skey & 7 != 2:
                    raise ValueError(f"summary field {skey >> 3}")
                vlen, spos = _read_varint(value, spos)
                vbuf = value[spos:spos + vlen]
                spos += vlen
                tag, val, vpos = None, None, 0
                while vpos < len(vbuf):
                    vkey, vpos = _read_varint(vbuf, vpos)
                    if vkey >> 3 == 1:
                        tlen, vpos = _read_varint(vbuf, vpos)
                        tag = vbuf[vpos:vpos + tlen].decode()
                        vpos += tlen
                    elif vkey >> 3 == 2:
                        val = struct.unpack_from("<f", vbuf, vpos)[0]
                        vpos += 4
                    else:
                        raise ValueError(f"value field {vkey >> 3}")
                scalars[tag] = val
    return step, scalars
