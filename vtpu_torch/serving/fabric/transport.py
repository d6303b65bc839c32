"""Fabric transports (the port's copy of vtpu/serving/fabric/transport.py):
a deterministic in-proc loopback and stdlib TCP.

Both implement one ``Channel`` surface (``send(msg, payload=None)`` /
``recv(timeout)`` / ``close()`` plus a counters dict), so ``EngineHost``
and ``RemoteEngine`` are transport-oblivious.

**Loopback** is the tests' workhorse: a queue pair whose messages
round-trip through the SAME payload encode/verify codec TCP uses (so the
checksum path runs in-proc), with deterministic fault seams riding the
``FaultPlan``: ``fabric_msg_loss`` drops the next message, ``fabric_delay``
defers its delivery, ``fabric_payload_corrupt`` flips a byte in a payload
chunk after the CRCs were computed; plus an explicit two-way ``partition``
toggle (messages sent while partitioned are LOST, exactly like a dead
link; the host/remote seq+resend protocol recovers them on heal, which is
what makes a network blip token-lossless).

**TCP** is length-prefixed stdlib framing (wire.py): one JSON control
frame per message, binary chunk frames for payloads, a send lock for
atomicity, typed ``TransportError`` on a broken peer. Receive is a timed
poll so owner threads can observe their stop events, backed by a stateful
buffer: bytes already read when the poll window lapses are KEPT and the
frame completes on a later poll, so a frame straddling poll windows can
never desync the stream into parsing mid-frame bytes as headers.
"""

from __future__ import annotations

import queue
import socket
import threading
import time
from typing import Optional, Tuple

from vtpu_torch.serving.fabric.wire import (
    FRAME_BIN,
    FRAME_JSON,
    HDR,
    MAX_FRAME,
    ChecksumError,
    ProtocolError,
    TransportError,
    decode_msg,
    decode_payload,
    encode_msg,
    encode_payload,
    send_frame,
)

__all__ = [
    "Channel", "LoopbackChannel", "TcpChannel", "TransportError",
    "ProtocolError", "ChecksumError", "loopback_pair", "tcp_connect",
    "new_counters",
]


def new_counters() -> dict:
    """One channel's transport counters, summed into the fleet's
    ``fabric_*`` stats keys."""
    return {
        "msgs_sent": 0, "msgs_recv": 0,
        "bytes_sent": 0, "bytes_recv": 0,
        "payload_bytes_sent": 0, "payload_bytes_recv": 0,
        "retries": 0, "timeouts": 0, "resends": 0,
        "checksum_faults": 0,
        "msgs_dropped": 0,  # loopback loss/partition drops (send side)
    }


class Channel:
    """Transport-agnostic message channel. ``send`` never blocks on the
    peer; ``recv`` returns ``(msg, payload)``: ``payload`` is the
    decoded per-plane dict of CPU tensors, or None (with
    ``msg["payload_lost"]=True`` and a counted ``checksum_faults``) when
    the payload arrived corrupt: the receiver falls back to recompute,
    never to wrong bytes."""

    def __init__(self):
        self.counters = new_counters()
        self._closed = False

    @property
    def closed(self) -> bool:
        return self._closed

    def send(self, msg: dict, payload: Optional[dict] = None) -> None:
        raise NotImplementedError

    def recv(self, timeout: Optional[float] = None
             ) -> Tuple[Optional[dict], Optional[dict]]:
        raise NotImplementedError

    def close(self) -> None:
        self._closed = True

    def _decode_payload(self, msg: dict, desc, chunks):
        """Shared checksum discipline: verify, or convert a corrupt
        payload to None + flag + counter."""
        if desc is None:
            return None
        try:
            return decode_payload(desc, chunks)
        except ChecksumError:
            self.counters["checksum_faults"] += 1
            msg["payload_lost"] = True
            return None


# ---------------------------------------------------------------- loopback


class _Link:
    """Shared state of a loopback pair: the partition toggle and the
    optional FaultPlan the fabric seams fire on."""

    def __init__(self, faults=None, delay_s: float = 0.02):
        self.faults = faults
        self.delay_s = delay_s
        self._partitioned = False

    def partition(self, on: bool = True) -> None:
        """Two-way message loss while set: the dead-link injection the
        SUSPECT-then-reconnect ladder tests drive. Messages sent during
        the partition are dropped, not queued: exactly a lossy network."""
        self._partitioned = bool(on)

    @property
    def partitioned(self) -> bool:
        return self._partitioned


class LoopbackChannel(Channel):
    """One end of an in-proc pair. Payloads round-trip through the wire
    codec (encode -> optional corruption seam -> CRC verify) so the
    checksum machinery is exercised without a socket."""

    def __init__(self, inbox: "queue.Queue", peer_inbox: "queue.Queue",
                 link: _Link):
        super().__init__()
        self._inbox = inbox
        self._peer_inbox = peer_inbox
        self._link = link

    def send(self, msg: dict, payload: Optional[dict] = None) -> None:
        if self._closed:
            raise TransportError("channel closed")
        body = encode_msg(msg)
        desc, chunks = encode_payload(payload)
        self.counters["msgs_sent"] += 1
        self.counters["bytes_sent"] += len(body) + sum(
            len(c) for c in chunks)
        if desc is not None:
            self.counters["payload_bytes_sent"] += desc["nbytes"]
        plan = self._link.faults
        if self._link.partitioned or (
                plan is not None and plan.fire("fabric_msg_loss")):
            self.counters["msgs_dropped"] += 1
            return
        if desc is not None and plan is not None \
                and plan.fire("fabric_payload_corrupt"):
            # flip one byte in the first chunk AFTER the CRCs were
            # computed: the receiver's verify must catch it
            chunks = [bytes([chunks[0][0] ^ 0xFF]) + chunks[0][1:]] \
                + chunks[1:]
        item = (body, desc, chunks)
        if plan is not None and plan.fire("fabric_delay"):
            timer = threading.Timer(self._link.delay_s,
                                    self._peer_inbox.put, args=(item,))
            timer.daemon = True
            timer.start()
        else:
            self._peer_inbox.put(item)

    def recv(self, timeout: Optional[float] = None):
        if self._closed:
            raise TransportError("channel closed")
        try:
            got = self._inbox.get(timeout=timeout)
        except queue.Empty:
            return None, None
        if got is None:  # peer closed
            raise TransportError("peer closed the connection")
        body, desc, chunks = got
        msg = decode_msg(body)
        self.counters["msgs_recv"] += 1
        self.counters["bytes_recv"] += len(body) + sum(
            len(c) for c in chunks)
        payload = self._decode_payload(msg, desc, chunks)
        if payload is not None and desc is not None:
            self.counters["payload_bytes_recv"] += desc["nbytes"]
        return msg, payload

    def close(self) -> None:
        if not self._closed:
            super().close()
            try:
                self._peer_inbox.put(None)
            except Exception:
                pass


def loopback_pair(faults=None, delay_s: float = 0.02
                  ) -> Tuple[LoopbackChannel, LoopbackChannel, _Link]:
    """A connected channel pair + the shared link (partition toggle).
    ``faults`` is a FaultPlan consulted at the fabric seams on every
    send, from EITHER end."""
    link = _Link(faults=faults, delay_s=delay_s)
    qa: "queue.Queue" = queue.Queue()
    qb: "queue.Queue" = queue.Queue()
    return (LoopbackChannel(qa, qb, link),
            LoopbackChannel(qb, qa, link), link)


# --------------------------------------------------------------------- tcp


#: per-chunk budget for payload frames already in flight behind their
#: JSON header; a stall this long mid-payload is a dead link, failed typed
FRAME_BUDGET_S = 30.0


class TcpChannel(Channel):
    """Length-prefixed stdlib TCP framing. One JSON frame per message;
    a message with a payload carries its descriptor inline
    (``_pchunks``) and is followed by that many binary chunk frames —
    the send lock keeps the sequence atomic across sender threads.

    Receive is stateful: partial frame bytes survive poll timeouts in
    ``_rxbuf`` and nothing is consumed until a whole frame is buffered,
    so the stream stays aligned on frame boundaries no matter how the
    caller's poll windows land."""

    def __init__(self, sock: socket.socket):
        super().__init__()
        self._sock = sock
        self._send_mu = threading.Lock()
        self._recv_mu = threading.Lock()
        self._rxbuf = bytearray()
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def send(self, msg: dict, payload: Optional[dict] = None) -> None:
        if self._closed:
            raise TransportError("channel closed")
        desc, chunks = encode_payload(payload)
        if desc is not None:
            msg = dict(msg)
            msg["_pdesc"] = desc
            msg["_pchunks"] = len(chunks)
        body = encode_msg(msg)
        with self._send_mu:
            n = send_frame(self._sock, FRAME_JSON, body)
            if desc is not None:
                for c in chunks:
                    n += send_frame(self._sock, FRAME_BIN, c)
        self.counters["msgs_sent"] += 1
        self.counters["bytes_sent"] += n
        if desc is not None:
            self.counters["payload_bytes_sent"] += desc["nbytes"]

    def _fill(self, n: int, deadline: Optional[float]) -> bool:
        """Grow the receive buffer to at least *n* bytes. Returns False
        when the deadline lapses first — with every byte already read
        KEPT in the buffer for the next poll — and raises a typed
        TransportError on EOF or a broken socket."""
        while len(self._rxbuf) < n:
            if deadline is None:
                self._sock.settimeout(None)
            else:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._sock.settimeout(left)
            try:
                part = self._sock.recv(1 << 16)
            except (socket.timeout, TimeoutError):
                return False
            except OSError as exc:
                raise TransportError(f"recv failed: {exc}") from None
            if not part:
                raise TransportError("peer closed the connection")
            self._rxbuf.extend(part)
        return True

    def _frame_at(self, off: int, deadline: Optional[float]):
        """Buffer one whole frame at offset *off* without consuming it.
        Returns ``(ftype, body_start, body_len)``, or None when the
        deadline lapses (partial bytes stay buffered)."""
        if not self._fill(off + HDR.size, deadline):
            return None
        length, ftype = HDR.unpack_from(self._rxbuf, off)
        if length > MAX_FRAME:
            raise ProtocolError(f"frame length {length} exceeds MAX_FRAME")
        if not self._fill(off + HDR.size + length, deadline):
            return None
        return ftype, off + HDR.size, length

    def recv(self, timeout: Optional[float] = None):
        if self._closed:
            raise TransportError("channel closed")
        with self._recv_mu:
            deadline = None if timeout is None \
                else time.monotonic() + timeout
            fr = self._frame_at(0, deadline)
            if fr is None:
                return None, None  # partial frame kept for the next poll
            ftype, start, length = fr
            if ftype != FRAME_JSON:
                raise ProtocolError(
                    f"expected a JSON frame, got type {ftype}")
            msg = decode_msg(bytes(self._rxbuf[start:start + length]))
            n = HDR.size + length
            desc = msg.pop("_pdesc", None)
            nchunks = int(msg.pop("_pchunks", 0))
            chunks = []
            off = start + length
            if desc is not None:
                # the chunks are already in flight behind the header:
                # a generous fixed budget per chunk, typed on timeout
                for _ in range(nchunks):
                    cfr = self._frame_at(
                        off, time.monotonic() + FRAME_BUDGET_S)
                    if cfr is None:
                        raise TransportError(
                            "payload chunk timed out mid-stream")
                    ft, cstart, clen = cfr
                    if ft != FRAME_BIN:
                        raise ProtocolError(
                            f"expected a BIN frame, got type {ft}")
                    chunks.append(bytes(self._rxbuf[cstart:cstart + clen]))
                    off = cstart + clen
                    n += HDR.size + clen
            del self._rxbuf[:off]
        self.counters["msgs_recv"] += 1
        self.counters["bytes_recv"] += n
        payload = self._decode_payload(msg, desc, chunks)
        if payload is not None and desc is not None:
            self.counters["payload_bytes_recv"] += desc["nbytes"]
        return msg, payload

    def close(self) -> None:
        if not self._closed:
            super().close()
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass


def tcp_connect(host: str, port: int, timeout: float = 10.0,
                retries: int = 3, backoff_s: float = 0.2) -> TcpChannel:
    """Dial an EngineHost with bounded per-attempt timeout and backoff'd
    retries; raises TransportError once the budget is spent."""
    last: Optional[Exception] = None
    for attempt in range(max(retries, 1)):
        if attempt:
            time.sleep(backoff_s * (2 ** (attempt - 1)))
        try:
            sock = socket.create_connection((host, port), timeout=timeout)
            return TcpChannel(sock)
        except OSError as exc:
            last = exc
    raise TransportError(
        f"could not connect to {host}:{port} after {retries} attempts: "
        f"{last}")
