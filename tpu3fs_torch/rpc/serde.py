"""Reflection-based binary serialization for dataclasses.

The port's own copy of ``tpu3fs/rpc/serde.py``,
unchanged but for its imports.

Plays the role of the reference's serde layer (src/common/serde/Serde.h:25-63):
there, C++ macros declare struct fields once and serialization, JSON render and
the RPC IDL all derive from that single declaration — no .proto codegen step.
Here the single declaration is a @dataclass with type hints; this module
derives a compact binary wire format and a JSON-ish debug render from the
hints. Wire types are resolved at first use and cached per class.

Wire format (little-endian):
  int        -> zigzag varint
  bool       -> 1 byte
  float      -> 8-byte IEEE double
  bytes      -> varint length + raw
  str        -> utf-8 as bytes
  enum       -> varint of value
  list[T]    -> varint count + elements
  dict[K,V]  -> varint count + interleaved k,v
  Optional[T]-> 1-byte presence + payload
  dataclass  -> varint field count + fields in declaration order

The trailing-field rule makes schema evolution additive like the reference's
(new fields must go last; old decoders ignore extras, new decoders default
missing trailing fields).
"""

from __future__ import annotations

import dataclasses
import enum
import struct
import typing
from typing import Any, Optional, Type, TypeVar, get_args, get_origin, get_type_hints

T = TypeVar("T")


# -- varint -----------------------------------------------------------------

def _write_uvarint(buf: bytearray, v: int) -> None:
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            buf.append(b | 0x80)
        else:
            buf.append(b)
            return


def _read_uvarint(data: memoryview, pos: int):
    shift = 0
    out = 0
    while True:
        b = data[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _zigzag(v: int) -> int:
    return (v << 1) ^ (v >> 63) if v < 0 else v << 1


def _unzigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


# -- compiled codecs ---------------------------------------------------------
# The wire format above is UNCHANGED; what changed is how it's driven.
# The original walker re-derived get_origin/get_args per FIELD per VALUE —
# measured ~20% of served-read CPU once payload copies were gone. Codecs
# are now compiled once per type into closure trees (one closure per node
# of the type tree) and cached; the hot loop runs no reflection at all.
# Dataclass field codecs resolve lazily on first use, which also breaks
# recursive type cycles.

_ENCODERS: dict = {}
_DECODERS: dict = {}


def _uvarint_bytes(v: int) -> bytes:
    buf = bytearray()
    _write_uvarint(buf, v)
    return bytes(buf)


def _build_encoder(hint: Any):
    origin = get_origin(hint)
    if hint is int:
        def enc_int(buf, value):
            v = int(value)
            v = (v << 1) ^ (v >> 63) if v < 0 else v << 1
            while v > 0x7F:
                buf.append((v & 0x7F) | 0x80)
                v >>= 7
            buf.append(v)
        return enc_int
    if hint is bool:
        return lambda buf, value: buf.append(1 if value else 0)
    if hint is float:
        pack = struct.Struct("<d").pack

        def enc_float(buf, value):
            buf += pack(value)
        return enc_float
    if hint is bytes:
        def enc_bytes(buf, value):
            n = len(value)
            while n > 0x7F:
                buf.append((n & 0x7F) | 0x80)
                n >>= 7
            buf.append(n)
            buf += value
        return enc_bytes
    if hint is str:
        def enc_str(buf, value):
            raw = value.encode("utf-8")
            n = len(raw)
            while n > 0x7F:
                buf.append((n & 0x7F) | 0x80)
                n >>= 7
            buf.append(n)
            buf += raw
        return enc_str
    if isinstance(hint, type) and issubclass(hint, enum.Enum):
        def enc_enum(buf, value):
            v = int(value.value)
            v = (v << 1) ^ (v >> 63) if v < 0 else v << 1
            while v > 0x7F:
                buf.append((v & 0x7F) | 0x80)
                v >>= 7
            buf.append(v)
        return enc_enum
    if origin in (list, tuple):
        (elem,) = get_args(hint)[:1]
        elem_enc = _encoder_for(elem)

        def enc_seq(buf, value):
            n = len(value)
            while n > 0x7F:
                buf.append((n & 0x7F) | 0x80)
                n >>= 7
            buf.append(n)
            for item in value:
                elem_enc(buf, item)
        return enc_seq
    if origin is dict:
        kt, vt = get_args(hint)
        kenc = _encoder_for(kt)
        venc = _encoder_for(vt)

        def enc_dict(buf, value):
            _write_uvarint(buf, len(value))
            for k, v in value.items():
                kenc(buf, k)
                venc(buf, v)
        return enc_dict
    if origin is typing.Union:
        args = [a for a in get_args(hint) if a is not type(None)]
        if len(args) != 1:
            raise TypeError(f"only Optional unions supported, got {hint}")
        inner = _encoder_for(args[0])

        def enc_opt(buf, value):
            if value is None:
                buf.append(0)
            else:
                buf.append(1)
                inner(buf, value)
        return enc_opt
    if dataclasses.is_dataclass(hint):
        fields = _fields_of(hint)
        header = _uvarint_bytes(len(fields))
        state: list = []

        def enc_dc(buf, value):
            if not state:  # lazy: breaks recursive type cycles
                state.append([(n, _encoder_for(h)) for n, h in fields])
            buf += header
            for name, fenc in state[0]:
                fenc(buf, getattr(value, name))
        return enc_dc
    raise TypeError(f"unsupported serde type: {hint!r}")


def _encoder_for(hint: Any):
    try:
        return _ENCODERS[hint]
    except (KeyError, TypeError):
        pass
    enc = _build_encoder(hint)
    try:
        _ENCODERS[hint] = enc
    except TypeError:
        pass  # unhashable hint: rebuilt per use (not seen in practice)
    return enc


def _build_decoder(hint: Any):
    origin = get_origin(hint)
    if hint is int:
        def dec_int(data, pos):
            shift = 0
            out = 0
            while True:
                b = data[pos]
                pos += 1
                out |= (b & 0x7F) << shift
                if not b & 0x80:
                    return (out >> 1) ^ -(out & 1), pos
                shift += 7
        return dec_int
    if hint is bool:
        return lambda data, pos: (bool(data[pos]), pos + 1)
    if hint is float:
        unpack_from = struct.Struct("<d").unpack_from

        def dec_float(data, pos):
            return unpack_from(data, pos)[0], pos + 8
        return dec_float
    if hint is bytes:
        def dec_bytes(data, pos):
            n, pos = _read_uvarint(data, pos)
            return bytes(data[pos:pos + n]), pos + n
        return dec_bytes
    if hint is str:
        def dec_str(data, pos):
            n, pos = _read_uvarint(data, pos)
            return str(data[pos:pos + n], "utf-8"), pos + n
        return dec_str
    if isinstance(hint, type) and issubclass(hint, enum.Enum):
        def dec_enum(data, pos):
            v, pos = _read_uvarint(data, pos)
            return hint((v >> 1) ^ -(v & 1)), pos
        return dec_enum
    if origin in (list, tuple):
        (elem,) = get_args(hint)[:1]
        elem_dec = _decoder_for(elem)
        as_tuple = origin is tuple

        def dec_seq(data, pos):
            n, pos = _read_uvarint(data, pos)
            out = []
            append = out.append
            for _ in range(n):
                item, pos = elem_dec(data, pos)
                append(item)
            return (tuple(out) if as_tuple else out), pos
        return dec_seq
    if origin is dict:
        kt, vt = get_args(hint)
        kdec = _decoder_for(kt)
        vdec = _decoder_for(vt)

        def dec_dict(data, pos):
            n, pos = _read_uvarint(data, pos)
            out = {}
            for _ in range(n):
                k, pos = kdec(data, pos)
                v, pos = vdec(data, pos)
                out[k] = v
            return out, pos
        return dec_dict
    if origin is typing.Union:
        args = [a for a in get_args(hint) if a is not type(None)]
        if len(args) != 1:
            raise TypeError(f"only Optional unions supported, got {hint}")
        inner = _decoder_for(args[0])

        def dec_opt(data, pos):
            present = data[pos]
            pos += 1
            if not present:
                return None, pos
            return inner(data, pos)
        return dec_opt
    if dataclasses.is_dataclass(hint):
        fields = _fields_of(hint)
        state: list = []

        def dec_dc(data, pos):
            if not state:  # lazy: breaks recursive type cycles
                state.append([(n, _decoder_for(h)) for n, h in fields])
            nfields, pos = _read_uvarint(data, pos)
            kwargs = {}
            for i, (name, fdec) in enumerate(state[0]):
                if i >= nfields:
                    break  # decoder newer: default missing trailing fields
                kwargs[name], pos = fdec(data, pos)
            # encoder newer than decoder: skipping unknown trailing fields
            # is not possible without self-describing wire; enforce at
            # call sites by only appending fields (same reference rule).
            return hint(**kwargs), pos
        return dec_dc
    raise TypeError(f"unsupported serde type: {hint!r}")


def _decoder_for(hint: Any):
    try:
        return _DECODERS[hint]
    except (KeyError, TypeError):
        pass
    dec = _build_decoder(hint)
    try:
        _DECODERS[hint] = dec
    except TypeError:
        pass
    return dec


# -- encode / decode (compat shims over the compiled codecs) -----------------

def _encode(buf: bytearray, value: Any, hint: Any) -> None:
    _encoder_for(hint)(buf, value)


def _decode(data: memoryview, pos: int, hint: Any):
    return _decoder_for(hint)(data, pos)


_FIELD_CACHE: dict = {}


def _fields_of(cls) -> list:
    cached = _FIELD_CACHE.get(cls)
    if cached is None:
        hints = get_type_hints(cls)
        cached = [(f.name, hints[f.name]) for f in dataclasses.fields(cls)]
        _FIELD_CACHE[cls] = cached
    return cached


# -- public API -------------------------------------------------------------

def serialize(value: Any, hint: Optional[Any] = None) -> bytes:
    buf = bytearray()
    _encoder_for(hint if hint is not None else type(value))(buf, value)
    return bytes(buf)


def deserialize(data: bytes, hint: Type[T]) -> T:
    value, pos = _decoder_for(hint)(memoryview(data), 0)
    if pos != len(data):
        raise ValueError(f"trailing bytes after decode: {len(data) - pos}")
    return value


def deserialize_prefix(data, hint: Type[T]):
    """Decode one value from the front of `data` (bytes or memoryview);
    -> (value, bytes_consumed). Trailing bytes are the caller's business —
    the bulk-framed RPC transport rides raw payload sections after the
    envelope (the RDMA-batch analogue, ref IBSocket.h:155-229)."""
    value, pos = _decoder_for(hint)(memoryview(data), 0)
    return value, pos


def serde_json(value: Any) -> Any:
    """Debug render: dataclass tree -> plain JSON-able structures."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {
            f.name: serde_json(getattr(value, f.name))
            for f in dataclasses.fields(value)
        }
    if isinstance(value, enum.Enum):
        return value.name
    if isinstance(value, bytes):
        return value.hex()
    if isinstance(value, (list, tuple)):
        return [serde_json(v) for v in value]
    if isinstance(value, dict):
        return {str(k): serde_json(v) for k, v in value.items()}
    return value
