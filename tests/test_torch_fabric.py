"""The port's fabric wire and transports (``vtpu_torch.serving.fabric.wire``
and ``.transport``) against vtpu's own copies (CPU).

Held: for the same message and a numpy payload (f32 and int8 planes, two
chunks), the port's ``encode_msg``, descriptor, chunks and frames are the
reference's byte for byte, and each package's ``decode_payload`` reads the
other's; a torch payload (bfloat16, which numpy lacks, beside int8 and
f32 planes at offsets a view cannot take) round-trips bit for bit, over the
loopback and over TCP; a flipped byte fails its CRC, typed, and on a
channel turns into ``payload=None`` with a counted fault; ``json_safe``
turns numpy and torch scalars into Python numbers. The reference's wire
cases (tests/test_crosshost.py): a hello of the wrong version is refused
typed, ``EngineSignals`` crosses as a dict (and between the packages), and
a TCP frame dripped across many poll windows never desyncs the stream."""

import json
import socket
import threading
import time

import numpy as np
import pytest
import torch

from vtpu.serving.fabric import transport as jtransport, wire as jwire
from vtpu.serving.shed import EngineSignals as JEngineSignals
from vtpu_torch.serving import FaultPlan
from vtpu_torch.serving.fabric import (
    ChecksumError,
    EngineHost,
    ProtocolError,
    TcpChannel,
    connect_host,
    loopback_pair,
    transport,
    wire,
)
from vtpu_torch.serving.shed import EngineSignals

MSG = {"kind": "ask", "op": "migrate_in", "ticket": 7, "meta": {"tokens": [1, 2, 3],
                                                              "pending": 4, "pid": None}}


def _numpy_payload():
    rs = np.random.RandomState(0)
    # the f32 plane spans past one chunk, so the payload ships as two
    return {"v": rs.randint(-128, 128, (3, 5, 7)).astype(np.int8),
            "k": rs.standard_normal((300_001,)).astype(np.float32)}


def _frames(desc, chunks, msg) -> bytes:
    """A message's TCP frames, as TcpChannel.send writes them."""
    body = dict(msg, _pdesc=desc, _pchunks=len(chunks))
    out = [wire.HDR.pack(len(e), wire.FRAME_JSON) + e for e in [wire.encode_msg(body)]]
    out += [wire.HDR.pack(len(c), wire.FRAME_BIN) + c for c in chunks]
    return b"".join(out)


def _jframes(desc, chunks, msg) -> bytes:
    body = dict(msg, _pdesc=desc, _pchunks=len(chunks))
    out = [jwire.HDR.pack(len(e), jwire.FRAME_JSON) + e for e in [jwire.encode_msg(body)]]
    out += [jwire.HDR.pack(len(c), jwire.FRAME_BIN) + c for c in chunks]
    return b"".join(out)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_numpy_payload_byte_identical_and_cross_decodes():
    """The port's message, descriptor, chunks and frames equal the
    reference's for a numpy payload; each package decodes the other's."""
    payload = _numpy_payload()
    assert wire.encode_msg(MSG) == jwire.encode_msg(MSG)
    assert (wire.PROTO_VERSION, wire.HDR.format, wire.CHUNK_BYTES, wire.MAX_FRAME) == (
        jwire.PROTO_VERSION, jwire.HDR.format, jwire.CHUNK_BYTES, jwire.MAX_FRAME)
    desc, chunks = wire.encode_payload(payload)
    jdesc, jchunks = jwire.encode_payload(payload)
    assert json.dumps(desc) == json.dumps(jdesc)
    assert len(chunks) == 2 and chunks == jchunks
    assert _frames(desc, chunks, MSG) == _jframes(jdesc, jchunks, MSG)
    assert wire.encode_payload(None) == jwire.encode_payload(None) == (None, [])
    mine, theirs = wire.decode_payload(jdesc, jchunks), jwire.decode_payload(desc, chunks)
    for key, arr in payload.items():
        assert mine[key].dtype == torch.from_numpy(arr).dtype
        assert np.array_equal(mine[key].numpy(), arr)
        assert theirs[key].dtype == arr.dtype and np.array_equal(theirs[key], arr)


def test_torch_payload_round_trips_bitwise():
    """bfloat16 (no numpy dtype), an odd-sized int8 plane that leaves the
    next plane's bytes unaligned, f32 and an empty plane: each decodes to a
    CPU tensor of its dtype and shape, bit for bit."""
    g = torch.Generator().manual_seed(0)
    payload = {"a_int8": torch.randint(-128, 128, (5,), generator=g, dtype=torch.int8),
               "b_bf16": torch.randn((2, 3, 129), generator=g).to(torch.bfloat16),
               "c_f32": torch.randn((7, 3), generator=g),
               "d_empty": torch.zeros((0, 4), dtype=torch.bfloat16)}
    desc, chunks = wire.encode_payload(payload)
    assert [p["dtype"] for p in desc["planes"]] == ["int8", "bfloat16", "float32", "bfloat16"]
    got = wire.decode_payload(json.loads(json.dumps(desc)), chunks)
    for key, t in payload.items():
        assert got[key].dtype == t.dtype and got[key].shape == t.shape
        assert got[key].device.type == "cpu"
        assert torch.equal(_bits(got[key]), _bits(t))


def test_flipped_byte_fails_typed_and_downgrades_on_a_channel():
    """A corrupted chunk raises ChecksumError in either package's decoder;
    on a loopback link the fabric_payload_corrupt seam flips a byte after
    the CRCs and the receiver gets payload=None, payload_lost and a counted
    fault; the next payload arrives whole."""
    payload = {"k": torch.randn((4, 8)).to(torch.bfloat16)}
    desc, chunks = wire.encode_payload(payload)
    bad = [bytes([chunks[0][0] ^ 0xFF]) + chunks[0][1:]]
    with pytest.raises(ChecksumError):
        wire.decode_payload(desc, bad)
    ndesc, nchunks = wire.encode_payload(_numpy_payload())
    with pytest.raises(jwire.ChecksumError):
        jwire.decode_payload(ndesc, [nchunks[0], nchunks[1][:-1] + b"\0"])
    with pytest.raises(ChecksumError):
        wire.decode_payload(desc, chunks + [b""])
    plan = FaultPlan()
    a, b, _ = loopback_pair(faults=plan, delay_s=0.0)
    plan.arm("fabric_payload_corrupt", count=1)
    a.send({"kind": "x"}, payload)
    a.send({"kind": "y"}, payload)
    msg, got = b.recv(timeout=1.0)
    assert got is None and msg["payload_lost"] is True
    msg2, got2 = b.recv(timeout=1.0)
    assert msg2 == {"kind": "y"} and torch.equal(_bits(got2["k"]), _bits(payload["k"]))
    assert b.counters["checksum_faults"] == 1
    assert a.counters["payload_bytes_sent"] == 2 * desc["nbytes"]
    assert b.counters["payload_bytes_recv"] == desc["nbytes"]
    assert set(transport.new_counters()) == set(jtransport.new_counters())


def test_json_safe_scalars():
    """numpy and torch scalars become Python numbers (the port's stats()
    crosses the wire), tuples lists; the numpy part as the reference does."""
    stats = {"n": np.int64(3), "x": np.float32(0.5), "b": np.bool_(True), "t": (1, 2),
             "s": "ok", "none": None}
    assert wire.json_safe(stats) == jwire.json_safe(stats)
    port = wire.json_safe({"launches": torch.tensor(12), "ms": torch.tensor(1.5),
                           "nested": {"k": [torch.tensor(True)]}})
    assert port == {"launches": 12, "ms": 1.5, "nested": {"k": [True]}}
    assert json.loads(wire.encode_msg({"v": np.int32(4), "w": torch.tensor(2)})) == {
        "v": 4, "w": 2}


def test_hello_version_mismatch_refused_typed(monkeypatch):
    """A protocol-version mismatch at hello is a typed refusal carrying both
    versions: the client raises ProtocolError, the host closes the channel;
    neither side hangs."""
    import vtpu_torch.serving.fabric.remote as remote_mod

    srv = EngineHost({"r0": object()})  # never touched before the refuse
    a, b, _ = loopback_pair(delay_s=0.0)
    served = threading.Thread(target=srv.serve_channel, args=(b,), daemon=True)
    served.start()
    monkeypatch.setattr(remote_mod, "PROTO_VERSION", 999)
    with pytest.raises(ProtocolError, match="refused.*host speaks 1, client sent 999"):
        connect_host(a, host="h0", timeout=10.0)
    served.join(10.0)
    assert not served.is_alive() and b.closed
    srv.stop()


def test_engine_signals_round_trip():
    """EngineSignals crosses the wire as a dict: to_dict/from_dict
    round-trips every field, unknown keys (a newer peer) are dropped and
    missing ones take defaults; the reference reads the port's dict and the
    port the reference's."""
    kw = dict(queue_depth=3, active_slots=2, pool_free=7, pool_used_hwm=9, parked_sessions=1,
              prefill_backlog=4, now_ns=123, pool_blocks=16, draining=True, duty=0.5,
              fabric_rtt_ms=1.25, fabric_gbps=8.0)
    sig = EngineSignals(**kw)
    assert EngineSignals.from_dict(sig.to_dict()) == sig
    d = json.loads(wire.encode_msg(sig.to_dict()))
    d["from_the_future"] = {"x": 1}
    assert EngineSignals.from_dict(d) == sig
    sparse = EngineSignals.from_dict({"queue_depth": 5})
    assert sparse.queue_depth == 5
    assert sparse.fabric_rtt_ms is None and sparse.duty is None
    assert JEngineSignals.from_dict(sig.to_dict()) == JEngineSignals(**kw)
    assert EngineSignals.from_dict(JEngineSignals(**kw).to_dict()) == sig


def _tcp_pair():
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    cli = socket.create_connection(srv.getsockname())
    conn, _ = srv.accept()
    srv.close()
    return cli, conn


def test_tcp_frame_straddling_poll_windows_never_desyncs():
    """Partial frame bytes survive poll timeouts: a frame dripped slower
    than the reader's poll window arrives whole over several polls, and the
    next frame still parses."""
    cli, conn = _tcp_pair()
    chan = TcpChannel(conn)
    try:
        msg = {"kind": "meta", "blob": "x" * 4096}
        body = wire.encode_msg(msg)
        frame = wire.HDR.pack(len(body), wire.FRAME_JSON) + body

        def drip():
            # ~25 pieces, each slower than the reader's 2 ms poll window
            for i in range(0, len(frame), 173):
                cli.sendall(frame[i:i + 173])
                time.sleep(0.004)
            body2 = wire.encode_msg({"kind": "after"})
            cli.sendall(wire.HDR.pack(len(body2), wire.FRAME_JSON) + body2)

        threading.Thread(target=drip, daemon=True).start()
        got = polls = None
        for polls in range(2000):
            got, _ = chan.recv(timeout=0.002)
            if got is not None:
                break
        assert got == msg and polls > 0
        got2 = None
        for _ in range(2000):
            got2, _ = chan.recv(timeout=0.002)
            if got2 is not None:
                break
        assert got2 == {"kind": "after"}
    finally:
        chan.close()
        cli.close()


def test_tcp_payload_round_trip_and_counters():
    """A torch payload over TCP: descriptor inline, chunks as binary
    frames, decoded bit for bit on the far end; both ends count the
    message, its bytes and the payload's."""
    cli, conn = _tcp_pair()
    a, b = TcpChannel(cli), TcpChannel(conn)
    try:
        payload = {"k": torch.randn((3, 1 << 18)).to(torch.bfloat16),
                   "s": torch.randn((3,), dtype=torch.float32)}
        desc, chunks = wire.encode_payload(payload)
        a.send({"kind": "ask_reply", "ticket": 1}, payload)
        msg, got = b.recv(timeout=10.0)
        assert msg == {"kind": "ask_reply", "ticket": 1}
        for key, t in payload.items():
            assert torch.equal(_bits(got[key]), _bits(t))
        assert len(chunks) == 2
        assert a.counters["payload_bytes_sent"] == b.counters["payload_bytes_recv"] \
            == desc["nbytes"]
        assert a.counters["bytes_sent"] == b.counters["bytes_recv"] > desc["nbytes"]
        assert (a.counters["msgs_sent"], b.counters["msgs_recv"]) == (1, 1)
    finally:
        a.close()
        b.close()
