"""The frame codec of the port, the counterpart of the first half of
``src/repro/serving/transport.py``: every message is a pickle (protocol 4)
payload behind an 8-byte ``<u32 length><u32 crc32>`` header. The write-ahead
journal (:class:`repro_torch.core.memory.MemoryJournal`) writes its records
with it, byte for byte as the JAX package does, so either package reads a
journal the other wrote. The crc catches torn or corrupt frames.

Frames carry host values only (numpy arrays and Python objects), never a
tensor. The framed channel of the process fabric is not ported yet.
"""
from __future__ import annotations

import pickle
import struct
import zlib

#: shared frame header: payload length, then crc32 of the payload
HEADER = struct.Struct("<II")
PICKLE_PROTOCOL = 4


class ChannelError(RuntimeError):
    """Base of transport failures."""


class FrameCorruption(ChannelError):
    """A frame arrived but its crc or header did not check out."""


def frame_payload(payload: bytes) -> bytes:
    """Prefix ``payload`` with the ``<u32 len><u32 crc32>`` header."""
    return HEADER.pack(len(payload),
                       zlib.crc32(payload) & 0xFFFFFFFF) + payload


def frame_message(obj) -> bytes:
    """Pickle ``obj`` and frame it."""
    return frame_payload(pickle.dumps(obj, protocol=PICKLE_PROTOCOL))


def check_frame(buf: bytes, offset: int = 0) -> tuple[object, int] | None:
    """Parse one frame from ``buf`` at ``offset``: ``(message,
    next_offset)``, or ``None`` at a clean end. Raises
    :class:`FrameCorruption` on a torn header, a torn payload or a crc
    mismatch."""
    n = len(buf) - offset
    if n == 0:
        return None
    if n < HEADER.size:
        raise FrameCorruption(
            f"torn frame header: {n} bytes, need {HEADER.size}")
    length, crc = HEADER.unpack_from(buf, offset)
    start = offset + HEADER.size
    if len(buf) - start < length:
        raise FrameCorruption(
            f"torn frame payload: {len(buf) - start} bytes, "
            f"header promised {length}")
    payload = buf[start:start + length]
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise FrameCorruption("frame crc mismatch")
    return pickle.loads(payload), start + length
