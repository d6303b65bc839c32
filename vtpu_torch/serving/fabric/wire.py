"""The fabric wire format (the port's copy of vtpu/serving/fabric/wire.py):
length-prefixed frames, stdlib only.

Everything the fleet exchanges is host-plain by design: the failover
ledger is metadata dicts, a migration or prefix payload is one host buffer
a KV plane, signals are a small frozen dataclass. So the wire is a 5-byte
header (``>IB``: body length + frame type), JSON bodies for control
messages and raw binary frames for payload chunks.

Versioning is explicit and fails typed: every connection opens with a
``hello`` frame carrying ``PROTO_VERSION``; a peer that cannot speak it
answers a ``refuse`` frame (reason + its own version) and closes, so a
mismatch surfaces as a typed :class:`ProtocolError` on the dialing side,
never as a hang on a half-understood stream.

Payloads ship as a JSON descriptor (per plane its key, dtype and shape;
per chunk a CRC32) followed by that many binary chunk frames. The
receiver verifies every chunk before reassembly; a mismatch raises
:class:`ChecksumError`, which the transport turns into ``payload=None`` so
the install falls back to recompute: corrupted bytes can delay a stream,
never fork it.

The port's payloads are torch tensors (pinned on a card; bfloat16 has no
numpy dtype), so a plane's bytes ship through a ``uint8`` view and its
descriptor names the torch dtype. A numpy plane ships as the reference
ships it, descriptor and chunks byte for byte, so either package's
``decode_payload`` reads the other's numpy payloads. Decoding always
yields CPU torch tensors.
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Optional, Tuple

import numpy as np
import torch

#: Explicit protocol version, carried in every hello frame. Bump on any
#: incompatible wire change; the peer refuses (typed), never guesses.
PROTO_VERSION = 1

# frame header: 4-byte big-endian body length + 1-byte frame type
HDR = struct.Struct(">IB")
FRAME_JSON = 1   # utf-8 JSON control message
FRAME_BIN = 2    # raw payload chunk (descriptor rode the preceding JSON)

#: payload chunk size: large enough to amortize framing, small enough
#: that a single corrupted chunk localizes the checksum fault
CHUNK_BYTES = 1 << 20

#: sanity bound on a single frame body (a corrupted length prefix must
#: fail typed, not attempt a multi-GB allocation)
MAX_FRAME = 1 << 30


class TransportError(RuntimeError):
    """A fabric link failed: connect refused, peer gone mid-frame, send
    or receive timed out past the retry budget. Typed so callers
    (RemoteEngine asks, the fleet's probe ladder) can tell a dead LINK
    from a dead ENGINE."""


class ProtocolError(TransportError):
    """The peer speaks a different protocol (version mismatch, malformed
    frame, refused hello). Never retried: reconnecting cannot fix it."""


class ChecksumError(TransportError):
    """A payload chunk failed its CRC32. The transport converts this to
    ``payload=None`` + a counted fault so the install recomputes from the
    token history instead of installing corrupted pages."""


# ------------------------------------------------------------------ frames


def _scalar(obj):
    """json.dumps's fallback: numpy and torch scalars (0-d tensors) as
    Python numbers; anything else is not JSON."""
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, torch.Tensor) and obj.dim() == 0:
        return obj.item()
    raise TypeError(f"{type(obj).__name__} is not JSON serializable")


def encode_msg(msg: dict) -> bytes:
    return json.dumps(msg, separators=(",", ":"), default=_scalar).encode("utf-8")


def decode_msg(data: bytes) -> dict:
    try:
        out = json.loads(data.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as exc:
        raise ProtocolError(f"malformed JSON frame: {exc}") from None
    if not isinstance(out, dict):
        raise ProtocolError(f"JSON frame is not an object: {type(out)}")
    return out


def send_frame(sock, ftype: int, data: bytes) -> int:
    """One frame onto a connected socket. Returns bytes written (header
    included). Raises TransportError on a broken pipe."""
    try:
        sock.sendall(HDR.pack(len(data), ftype))
        if data:
            sock.sendall(data)
    except OSError as exc:
        raise TransportError(f"send failed: {exc}") from None
    return HDR.size + len(data)


# ----------------------------------------------------------------- payload


def _plane_bytes(x) -> Tuple[str, list, bytes]:
    """(dtype descriptor, shape, raw bytes) of one plane: a torch tensor
    names its torch dtype and ships through a uint8 view; a numpy array
    keeps the reference's numpy dtype string."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu").contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        return str(t.dtype).removeprefix("torch."), list(t.shape), raw
    arr = np.ascontiguousarray(x)
    return arr.dtype.str, list(arr.shape), arr.tobytes()


def _torch_dtype(name: str) -> torch.dtype:
    """A descriptor's dtype as a torch dtype: a torch dtype name
    ("bfloat16"), or a numpy dtype string ("<f4") from a numpy plane."""
    dt = getattr(torch, name, None)
    if isinstance(dt, torch.dtype):
        return dt
    return torch.from_numpy(np.empty(0, np.dtype(name))).dtype


def encode_payload(payload: Optional[dict]) -> Tuple[Optional[dict], list]:
    """Serialize a payload ({plane key: torch tensor or numpy array}) to a
    JSON-safe descriptor + binary chunks. Plane bytes concatenate in
    sorted-key order; chunks carry individual CRC32s so corruption
    localizes. Returns (None, []) for a payload-less transfer."""
    if payload is None:
        return None, []
    planes = []
    blobs = []
    for key in sorted(payload):
        dtype, shape, raw = _plane_bytes(payload[key])
        planes.append({"key": key, "dtype": dtype, "shape": shape})
        blobs.append(raw)
    body = b"".join(blobs)
    chunks = [body[i:i + CHUNK_BYTES]
              for i in range(0, len(body), CHUNK_BYTES)] or [b""]
    desc = {"planes": planes, "nbytes": len(body),
            "crcs": [zlib.crc32(c) & 0xFFFFFFFF for c in chunks]}
    return desc, chunks


def decode_payload(desc: Optional[dict], chunks: list) -> Optional[dict]:
    """Reassemble and verify a payload into CPU torch tensors. Raises
    ChecksumError when any chunk fails its CRC (the caller converts to
    the recompute path)."""
    if desc is None:
        return None
    crcs = desc["crcs"]
    if len(chunks) != len(crcs):
        raise ChecksumError(
            f"payload arrived with {len(chunks)} chunks, expected "
            f"{len(crcs)}")
    for i, (chunk, crc) in enumerate(zip(chunks, crcs)):
        if (zlib.crc32(chunk) & 0xFFFFFFFF) != crc:
            raise ChecksumError(f"payload chunk {i} failed its CRC32")
    nbytes = sum(len(c) for c in chunks)
    if nbytes != desc["nbytes"]:
        raise ChecksumError(
            f"payload reassembled to {nbytes} bytes, expected "
            f"{desc['nbytes']}")
    body = bytearray(nbytes)
    pos = 0
    for c in chunks:
        body[pos:pos + len(c)] = c
        pos += len(c)
    out = {}
    pos = 0
    for p in desc["planes"]:
        dt = _torch_dtype(p["dtype"])
        shape = tuple(p["shape"])
        size = torch.empty((), dtype=dt).element_size()
        n = size * int(np.prod(shape, dtype=np.int64))
        if n == 0:
            out[p["key"]] = torch.empty(shape, dtype=dt)
            continue
        raw = torch.frombuffer(body, dtype=torch.uint8, offset=pos, count=n)
        if pos % size:
            raw = raw.clone()  # a view needs an offset aligned to the dtype
        out[p["key"]] = raw.view(dt).reshape(shape)
        pos += n
    return out


def json_safe(obj):
    """Best-effort conversion of a stats()/signals dict to JSON-safe
    types (numpy and torch scalars -> python, tuples -> lists, unknown ->
    repr)."""
    if isinstance(obj, dict):
        return {str(k): json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    if isinstance(obj, torch.Tensor) and obj.dim() == 0:
        return obj.item()
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return repr(obj)
