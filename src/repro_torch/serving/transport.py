"""Framed messages of the port, the counterpart of
``src/repro/serving/transport.py``: every message is a pickle (protocol 4)
payload behind an 8-byte ``<u32 length><u32 crc32>`` header. The write-ahead
journal (:class:`repro_torch.core.memory.MemoryJournal`) writes its records
with it, byte for byte as the JAX package does, so either package reads a
journal the other wrote; the process fabric's :class:`FramedChannel` sends
its messages with it. The crc catches torn or corrupt frames, and a short
read (the peer died mid-frame) surfaces as :class:`ChannelClosed`.

Frames carry host values only (numpy arrays and Python objects), never a
tensor: a CUDA tensor would need the sender's context on the other side.
"""
from __future__ import annotations

import pickle
import struct
import threading
import zlib

#: shared frame header: payload length, then crc32 of the payload
HEADER = struct.Struct("<II")
PICKLE_PROTOCOL = 4


class ChannelError(RuntimeError):
    """Base of transport failures."""


class ChannelClosed(ChannelError):
    """The peer's end of the channel is gone (clean close, process exit or
    SIGKILL: a dead process closes its pipe either way)."""


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


class FramedChannel:
    """One end of a duplex framed pickle channel over a
    ``multiprocessing.connection.Connection``.

    Sends are serialized under a lock, so a worker's heartbeat thread and
    its serve loop share the channel; receives have one consumer (the
    parent's reader thread for the worker, the worker's main loop). A
    ``fault_plan`` fires its ``"transport_frame"`` site before every send:
    ``"delay"`` adds wire latency, ``"crash"`` kills the sending end."""

    def __init__(self, conn, *, fault_plan=None, end: str = "",
                 replica: int | None = None):
        self.conn = conn
        self.fault_plan = fault_plan
        self.end = end                  # "parent" / "worker": the fault id
        self.replica = replica
        self._send_lock = threading.Lock()
        # frames sent while send_first's frame is still on its way, in
        # order (None once it and they are written)
        self._backlog: list[bytes] | None = None
        self.sent = 0
        self.received = 0

    def send(self, obj) -> None:
        """Frame and send one message; :class:`ChannelClosed` if the peer
        is gone."""
        self.send_raw(frame_message(obj))

    def send_raw(self, data: bytes) -> None:
        """Send an already framed message (the epoch broadcast frames once
        and sends the same bytes to every worker); the fault site still
        fires for each channel."""
        if self.fault_plan is not None:
            ids = {"end": self.end}
            if self.replica is not None:
                ids["replica"] = self.replica
            self.fault_plan.fire("transport_frame", **ids)
        try:
            with self._send_lock:
                if self._backlog is not None:
                    self._backlog.append(data)   # after the first frame
                    return
                self.conn.send_bytes(data)
                self.sent += 1
        except (BrokenPipeError, EOFError, OSError) as e:
            raise ChannelClosed(f"send to closed channel: {e}") from e

    def send_first(self, obj) -> None:
        """Send ``obj`` on a thread of its own and return at once: a large
        first frame (a worker's start payload) does not hold the caller
        while the peer starts up and reads it. Frames sent meanwhile queue
        behind it without blocking and follow it in order. No fault site
        fires for it; a closed peer surfaces at the next receive."""
        data = frame_message(obj)
        with self._send_lock:
            self._backlog = []

        def run():
            frames = [data]
            try:
                while True:
                    for frame in frames:
                        self.conn.send_bytes(frame)
                        self.sent += 1
                    with self._send_lock:
                        frames, self._backlog = self._backlog, \
                            ([] if self._backlog else None)
                        if not frames:
                            return
            except (BrokenPipeError, EOFError, OSError):
                with self._send_lock:
                    self._backlog = None
        threading.Thread(target=run, name=f"send-first-{self.end}",
                         daemon=True).start()

    def recv(self):
        """Block for one message; :class:`ChannelClosed` when the peer's
        end is closed (a dead process included)."""
        try:
            buf = self.conn.recv_bytes()
        except EOFError as e:
            raise ChannelClosed("peer closed the channel") from e
        except (BrokenPipeError, OSError) as e:
            raise ChannelClosed(f"channel read failed: {e}") from e
        parsed = check_frame(buf)
        if parsed is None:
            raise FrameCorruption("empty frame")
        msg, end = parsed
        if end != len(buf):
            raise FrameCorruption(
                f"{len(buf) - end} trailing bytes after frame")
        self.received += 1
        return msg

    def poll(self, timeout: float = 0.0) -> bool:
        try:
            return self.conn.poll(timeout)
        except (BrokenPipeError, EOFError, OSError):
            return True     # a closed pipe is readable: recv raises Closed

    def close(self) -> None:
        try:
            self.conn.close()
        except OSError:
            pass


def channel_pair(ctx=None) -> tuple:
    """A connected pair of raw duplex connections (parent end, worker
    end); each side wraps its own in a :class:`FramedChannel`. The worker
    end pickles into a ``Process``'s arguments."""
    import multiprocessing as mp
    ctx = ctx or mp
    return ctx.Pipe(duplex=True)
