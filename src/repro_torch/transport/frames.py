"""Wire format: length-prefixed, codec-tagged frames with array packing.

Every message on the wire is one **frame**::

    [4-byte big-endian length N] [1 codec byte] [N-1 payload bytes]

The codec byte selects the payload encoding — ``J`` (JSON, always
available, arrays base64-wrapped) or ``M`` (msgpack, binary-native,
used when the ``msgpack`` package is importable).  The length covers the
codec byte, so a reader can bound-check before buffering and a stream can
mix codecs frame by frame (a JSON client can talk to a msgpack-preferring
master).  Frames decode to a dict with at least a ``"kind"`` key.

Robustness contract: :class:`FrameReader` is an incremental parser that
NEVER raises on partial input (it just waits for more bytes) and raises
:class:`FrameError` exactly when the stream is provably corrupt —
oversized or zero length, unknown codec byte, undecodable payload, or a
payload that is not a dict with a string ``"kind"``.  After a FrameError
the stream has no resynchronization point (the length prefix itself is
untrusted), so the owning connection must be closed; the peer's
capped-backoff reconnect recovers.  This is what the fuzz tests drive:
arbitrary byte corruption must surface as FrameError or a clean decode,
never as an unhandled exception or a hung parser.

Arrays cross the wire via :func:`pack_array` / :func:`unpack_array`
(dtype + shape + raw little-endian bytes), which round-trip bit-exactly —
the foundation of the record/replay checksum contract.

The port's copy of the JAX package's ``transport/frames.py``: the same
bytes in both codecs, so either package's peer decodes the other's frames.
Nothing requires msgpack; a host without it speaks JSON, and a peer that
prefers msgpack still reads those frames (the codec byte is per frame).
"""
from __future__ import annotations

import base64
import json
import struct
from typing import Any

import numpy as np

try:                                    # optional: where it is not
    import msgpack                      # installed, every frame is JSON
except ImportError:                     # pragma: no cover - env dependent
    msgpack = None

MAX_FRAME = 16 * 1024 * 1024            # 16 MiB: > any sane (k, d) payload
_LEN = struct.Struct(">I")
CODEC_JSON = ord("J")
CODEC_MSGPACK = ord("M")

# frame kinds (the protocol vocabulary; field contracts live with the
# master/worker handlers that validate them)
HELLO = "hello"            # peer -> master: {"role": "worker"|"client", ...}
READY = "ready"            # worker -> master: warmed up, serving
REQ = "req"                # request: {"rid", "q", "k", "n_probe", ...}
RESP = "resp"              # response: {"rid", "dists", "ids", "checksum"}
ERR = "err"                # typed error: {"rid"?, "code", "detail"}
RETRY_AFTER = "retry_after"  # 429-style backpressure: {"rid", "delay_s"}
HB = "hb"                  # heartbeat: {"wid"}
BYE = "bye"                # orderly shutdown


class FrameError(ValueError):
    """The stream is corrupt at frame granularity; close the connection."""


def default_codec() -> str:
    return "msgpack" if msgpack is not None else "json"


def _to_jsonable(obj: Any) -> Any:
    if isinstance(obj, bytes):
        return {"__b64__": base64.b64encode(obj).decode("ascii")}
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    return obj


def _from_jsonable(obj: Any) -> Any:
    if isinstance(obj, dict):
        if set(obj) == {"__b64__"} and isinstance(obj["__b64__"], str):
            return base64.b64decode(obj["__b64__"])
        return {k: _from_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_from_jsonable(v) for v in obj]
    return obj


def encode_frame(frame: dict, codec: str | None = None,
                 max_frame: int = MAX_FRAME) -> bytes:
    """One dict -> length-prefixed bytes ready for the socket."""
    codec = codec or default_codec()
    if not isinstance(frame, dict) or not isinstance(frame.get("kind"), str):
        raise FrameError(f"frame must be a dict with a str 'kind', "
                         f"got {type(frame).__name__}")
    if codec == "json":
        body = json.dumps(_to_jsonable(frame), sort_keys=True,
                          separators=(",", ":")).encode()
        tag = CODEC_JSON
    elif codec == "msgpack":
        if msgpack is None:
            raise FrameError("msgpack codec requested but the msgpack "
                             "package is not installed")
        body = msgpack.packb(frame, use_bin_type=True)
        tag = CODEC_MSGPACK
    else:
        raise FrameError(f"unknown codec {codec!r}")
    n = len(body) + 1
    if n > max_frame:
        raise FrameError(f"frame of {n} bytes exceeds max_frame={max_frame}")
    return _LEN.pack(n) + bytes([tag]) + body


def _decode_body(tag: int, body: bytes) -> dict:
    if tag == CODEC_JSON:
        try:
            obj = _from_jsonable(json.loads(body.decode("utf-8")))
        except (ValueError, UnicodeDecodeError) as e:
            raise FrameError(f"undecodable JSON frame: {e}") from e
    elif tag == CODEC_MSGPACK:
        if msgpack is None:
            raise FrameError("received a msgpack frame but the msgpack "
                             "package is not installed")
        try:
            obj = msgpack.unpackb(body, raw=False, strict_map_key=False)
        except Exception as e:            # msgpack raises a zoo of types
            raise FrameError(f"undecodable msgpack frame: {e}") from e
    else:
        raise FrameError(f"unknown codec byte {tag:#04x}")
    if not isinstance(obj, dict) or not isinstance(obj.get("kind"), str):
        raise FrameError("frame payload is not a dict with a str 'kind'")
    return obj


class FrameReader:
    """Incremental frame parser over an untrusted byte stream."""

    def __init__(self, max_frame: int = MAX_FRAME):
        self.max_frame = int(max_frame)
        self._buf = bytearray()

    def pending(self) -> int:
        """Bytes buffered but not yet parsed (mid-frame)."""
        return len(self._buf)

    def feed(self, data: bytes) -> list[dict]:
        """Append ``data``; return every complete frame it finished.

        Raises :class:`FrameError` on provable corruption; the reader is
        then poisoned (the buffer is cleared) and the caller must close
        the connection.
        """
        self._buf.extend(data)
        out: list[dict] = []
        while True:
            if len(self._buf) < _LEN.size:
                return out
            (n,) = _LEN.unpack_from(self._buf)
            if n < 1 or n > self.max_frame:
                self._buf.clear()
                raise FrameError(
                    f"frame length {n} outside (0, {self.max_frame}]")
            if len(self._buf) < _LEN.size + n:
                return out
            tag = self._buf[_LEN.size]
            body = bytes(self._buf[_LEN.size + 1:_LEN.size + n])
            del self._buf[:_LEN.size + n]
            try:
                out.append(_decode_body(tag, body))
            except FrameError:
                self._buf.clear()
                raise


# --------------------------------------------------------------------------
# Array packing (bit-exact round trip)
# --------------------------------------------------------------------------

_ALLOWED_DTYPES = ("float32", "float64", "int32", "int64", "uint32",
                   "uint64", "float16", "int16", "uint16", "int8", "uint8")


def pack_array(arr: np.ndarray) -> dict:
    """ndarray -> {"dtype", "shape", "data"} with raw C-order bytes."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name not in _ALLOWED_DTYPES:
        raise FrameError(f"unsupported array dtype {arr.dtype.name!r}")
    return {"dtype": arr.dtype.name, "shape": list(arr.shape),
            "data": arr.tobytes()}


def unpack_array(obj: Any, max_elems: int = 1 << 24) -> np.ndarray:
    """Inverse of :func:`pack_array`, validating every field (this runs on
    untrusted input at the request boundary)."""
    if not isinstance(obj, dict):
        raise FrameError(f"packed array must be a dict, "
                         f"got {type(obj).__name__}")
    dtype, shape, data = obj.get("dtype"), obj.get("shape"), obj.get("data")
    if dtype not in _ALLOWED_DTYPES:
        raise FrameError(f"unsupported array dtype {dtype!r}")
    if not isinstance(shape, list) or not shape or \
            not all(isinstance(s, int) and 0 < s for s in shape):
        raise FrameError(f"bad array shape {shape!r}")
    n = int(np.prod(shape, dtype=np.int64))
    if n > max_elems:
        raise FrameError(f"array of {n} elements exceeds cap {max_elems}")
    if not isinstance(data, (bytes, bytearray)):
        raise FrameError("array data must be bytes")
    dt = np.dtype(dtype)
    if len(data) != n * dt.itemsize:
        raise FrameError(
            f"array data is {len(data)} bytes, expected {n * dt.itemsize}")
    return np.frombuffer(bytes(data), dtype=dt).reshape(shape)
