"""The port's RPC wire against the JAX package's, byte for byte.

Every wire dataclass of ``tpu3fs/rpc/services.py`` (and the envelope,
``MessagePacket``), and of ``kv/service.py`` (the kvd and its WAL
record), ``kv/replica.py`` (the kvd group's Raft messages and log
entries), ``monitor/collector.py`` (sample push, ``aggQuery``,
``sloStatus``) and ``serving/service.py`` (the peer-fill protocol), is
built in both packages from one seed, field by field
from the type hints (nested dataclasses, lists, dicts, optionals and
enums included); the two ``serialize`` calls must give equal bytes, and
each package must decode the other's bytes. The bulk section codec
(``pack_bulk_header``/``split_bulk``) must agree, errors included, and a
frame written by one package's ``_send_packet`` must be read by the
other's ``_recv_packet``."""

import dataclasses
import enum
import socket
import threading
import typing

import numpy as np
import pytest

import importlib

import tpu3fs.rpc.net as jax_net
import tpu3fs.rpc.serde as jax_serde
import tpu3fs.rpc.services as jax_services
import tpu3fs_torch.rpc.net as port_net
import tpu3fs_torch.rpc.serde as port_serde
import tpu3fs_torch.rpc.services as port_services

# the other modules whose dataclasses cross the wire (or a kvd's files),
# each named by its path under the package
WIRE_MODULES = ("kv.service", "kv.replica", "monitor.collector",
                "serving.service")


def _module_classes(module):
    return {name for name, obj in vars(module).items()
            if dataclasses.is_dataclass(obj) and isinstance(obj, type)
            and obj.__module__ == module.__name__}


def _wire_classes():
    names = sorted(_module_classes(jax_services)) + ["net.MessagePacket",
                                                    "net.Timestamps"]
    for mod in WIRE_MODULES:
        names += sorted(f"{mod}.{name}" for name in _module_classes(
            importlib.import_module(f"tpu3fs.{mod}")))
    return names


def _resolve(pkg_services, pkg_net, name):
    if name.startswith("net."):
        return getattr(pkg_net, name[4:])
    mod, _, cls = name.rpartition(".")
    if mod:
        root = pkg_services.__name__.split(".")[0]
        return getattr(importlib.import_module(f"{root}.{mod}"), cls)
    return getattr(pkg_services, name)


def _draw(hint, rng, depth: int = 0):
    """A seeded value of ``hint``: the same draws in the same order for
    both packages' (structurally equal) types."""
    origin = typing.get_origin(hint)
    if hint is int:
        return int(rng.integers(-(1 << 40), 1 << 40))
    if hint is bool:
        return bool(rng.integers(0, 2))
    if hint is float:
        return float(rng.standard_normal())
    if hint is bytes:
        return rng.bytes(int(rng.integers(0, 40)))
    if hint is str:
        return "".join(chr(int(c)) for c in
                       rng.integers(0x20, 0x3000, int(rng.integers(0, 12))))
    if isinstance(hint, type) and issubclass(hint, enum.Enum):
        members = list(hint)
        return members[int(rng.integers(0, len(members)))]
    if origin in (list, tuple):
        (elem,) = typing.get_args(hint)[:1]
        n = 0 if depth > 2 else int(rng.integers(0, 3))
        out = [_draw(elem, rng, depth + 1) for _ in range(n)]
        return tuple(out) if origin is tuple else out
    if origin is dict:
        kt, vt = typing.get_args(hint)
        n = 0 if depth > 2 else int(rng.integers(0, 3))
        return {_draw(kt, rng, depth + 1): _draw(vt, rng, depth + 1)
                for _ in range(n)}
    if origin is typing.Union:
        (inner,) = [a for a in typing.get_args(hint) if a is not type(None)]
        if depth > 2 or not rng.integers(0, 2):
            return None
        return _draw(inner, rng, depth + 1)
    if dataclasses.is_dataclass(hint):
        hints = typing.get_type_hints(hint)
        return hint(**{f.name: _draw(hints[f.name], rng, depth + 1)
                       for f in dataclasses.fields(hint)})
    raise TypeError(f"no draw for {hint!r}")


@pytest.mark.parametrize("name", _wire_classes())
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wire_type_serializes_equal(name, seed):
    jax_cls = _resolve(jax_services, jax_net, name)
    port_cls = _resolve(port_services, port_net, name)
    assert [f.name for f in dataclasses.fields(jax_cls)] == \
        [f.name for f in dataclasses.fields(port_cls)]
    jv = _draw(jax_cls, np.random.default_rng(seed))
    pv = _draw(port_cls, np.random.default_rng(seed))
    raw = jax_serde.serialize(jv)
    assert port_serde.serialize(pv) == raw
    # each package decodes the other's bytes to its own equal value
    assert port_serde.deserialize(raw, port_cls) == pv
    assert jax_serde.deserialize(port_serde.serialize(pv), jax_cls) == jv


def test_every_wire_type_of_the_port_is_held():
    """The port declares no wire dataclass the JAX package lacks, in
    ``rpc/services.py`` or in any other module of the wire."""
    port = _module_classes(port_services)
    for mod in WIRE_MODULES:
        port |= {f"{mod}.{name}" for name in _module_classes(
            importlib.import_module(f"tpu3fs_torch.{mod}"))}
    assert port == set(_wire_classes()) - {"net.MessagePacket",
                                           "net.Timestamps"}


@pytest.mark.parametrize("lens", [[], [0], [1], [5, 0, 300], [127, 128, 1 << 14]])
def test_bulk_header_and_split_agree(lens):
    rng = np.random.default_rng(len(lens))
    iovs = [rng.bytes(n) for n in lens]
    hdr = jax_net.pack_bulk_header(iovs)
    assert port_net.pack_bulk_header(iovs) == hdr
    section = hdr + b"".join(iovs)
    got = [bytes(m) for m in port_net.split_bulk(section)]
    assert got == [bytes(m) for m in jax_net.split_bulk(section)] == iovs


@pytest.mark.parametrize("section", [
    b"",                                  # truncated: no count
    b"\x02\x05",                          # truncated: a length missing
    b"\x01\x85",                          # truncated: a varint cut mid-byte
    b"\x01\x05abc",                       # a segment overruns the section
    b"\x01\x01ab",                        # trailing bytes
], ids=["empty", "short-lens", "cut-varint", "overrun", "trailing"])
def test_bulk_split_errors_agree(section):
    msgs = []
    for net in (jax_net, port_net):
        with pytest.raises(ConnectionError) as e:
            net.split_bulk(section)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _packet(net, rng, bulk: bool):
    pkt = _draw(net.MessagePacket, rng)
    pkt.flags &= ~net.FLAG_BULK
    iovs = [rng.bytes(n) for n in (3, 0, 70_000)] if bulk else None
    return pkt, iovs


@pytest.mark.parametrize("bulk", [False, True], ids=["inline", "bulk"])
@pytest.mark.parametrize("sender,receiver", [(jax_net, port_net),
                                             (port_net, jax_net)],
                         ids=["jax-to-port", "port-to-jax"])
def test_frames_cross_between_packages(sender, receiver, bulk):
    a, b = socket.socketpair()
    try:
        pkt, iovs = _packet(sender, np.random.default_rng(7), bulk)
        t = threading.Thread(target=sender._send_packet,
                             args=(a, pkt, threading.Lock(), iovs))
        t.start()
        got, segs = receiver._recv_packet(b)
        t.join(10.0)
        assert not t.is_alive()
        # the sender set FLAG_BULK on its packet when it had a bulk section
        assert receiver.serialize(got) == sender.serialize(pkt)
        assert bool(got.flags & receiver.FLAG_BULK) == bulk
        if bulk:
            assert [bytes(s) for s in segs] == iovs
        else:
            assert segs is None
    finally:
        a.close()
        b.close()
