"""The port's C++ transport (``tpu3fs_torch/rpc/native_net.py`` over
``tpu3fs_torch/hostsrc/rpc_net.cpp``) against the JAX package's Python and
native transports, both ways: ``tests/test_native_rpc.py``'s cases (echo,
unknown service and method, big payloads, reuse, bulk framing, malformed
packets, concurrency) with the port's native server under every client of
either package, and the port's native client against every server of
either package. The wire is one codec, so every pairing must answer the
same bytes. ``kv_main --rpc native`` answers a seeded Kv RPC sequence
with a JAX kvd's bytes."""

import importlib
import socket
import struct
import threading

import pytest

PY, NATIVE = "rpc.net", "rpc.native_net"
SERVERS = {"jax-py": ("tpu3fs", PY), "jax-native": ("tpu3fs", NATIVE),
           "port-py": ("tpu3fs_torch", PY),
           "port-native": ("tpu3fs_torch", NATIVE)}
# every pairing with the port's native transport on at least one side
PAIRS = ([("port-native", c) for c in SERVERS]
         + [(s, "port-native") for s in SERVERS if s != "port-native"])
BULK_SERVICE_ID = 9999


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def new_server(name: str):
    pkg, module = SERVERS[name]
    cls = "NativeRpcServer" if module == NATIVE else "RpcServer"
    return pkg, getattr(mod(pkg, module), cls)()


def new_client(name: str):
    pkg, module = SERVERS[name]
    cls = "NativeRpcClient" if module == NATIVE else "RpcClient"
    return pkg, getattr(mod(pkg, module), cls)()


def bind_bulk(pkg: str, server) -> None:
    svc = mod(pkg, "rpc.services")
    s = mod(pkg, "rpc.net").ServiceDef(BULK_SERVICE_ID, "BulkEcho")

    def bulk_echo(req, segs):
        if segs is None:
            return svc.EchoRsp("inline"), None
        return (svc.EchoRsp(f"segs={len(segs)}"),
                [bytes(x)[::-1] for x in segs])

    s.method(1, "bulkEcho", svc.EchoReq, svc.EchoRsp, bulk_echo, bulk=True)
    s.method(2, "plain", svc.EchoReq, svc.EchoRsp,
             lambda r: svc.EchoRsp(r.text))
    server.add_service(s)


@pytest.fixture(params=PAIRS, ids=lambda p: f"{p[0]}-server-{p[1]}-client")
def pair(request):
    """A server with the core and bulk-echo services and a client, each
    of its own package; -> (server, client, the client's package)."""
    spkg, server = new_server(request.param[0])
    mod(spkg, "rpc.services").bind_core_service(server)
    bind_bulk(spkg, server)
    server.start()
    cpkg, client = new_client(request.param[1])
    try:
        yield server, client, cpkg
    finally:
        client.close()
        server.stop()


def echo(client, cpkg, addr, text, service=None, method=1):
    svc = mod(cpkg, "rpc.services")
    return client.call(addr, svc.CORE_SERVICE_ID if service is None
                       else service, method, svc.EchoReq(text), svc.EchoRsp)


def code_of(cpkg, fn) -> int:
    with pytest.raises(mod(cpkg, "utils.result").FsError) as ei:
        fn()
    return int(ei.value.code)


class TestInterop:
    def test_echo_big_payload_and_reuse(self, pair):
        server, client, cpkg = pair
        assert echo(client, cpkg, server.address, "ping").text == "ping"
        big = "x" * (4 << 20)
        assert echo(client, cpkg, server.address, big).text == big
        for i in range(50):
            assert echo(client, cpkg, server.address,
                        f"m{i}").text == f"m{i}"

    def test_unknown_service_and_method(self, pair):
        server, client, cpkg = pair
        Code = mod(cpkg, "utils.result").Code
        assert code_of(cpkg, lambda: echo(client, cpkg, server.address, "x",
                                          service=999)) \
            == Code.RPC_SERVICE_NOT_FOUND
        assert code_of(cpkg, lambda: echo(client, cpkg, server.address, "x",
                                          method=99)) \
            == Code.RPC_METHOD_NOT_FOUND


class TestBulkFraming:
    def bulk(self, pair, iovs, method=1):
        server, client, cpkg = pair
        svc = mod(cpkg, "rpc.services")
        return client.call_bulk(server.address, BULK_SERVICE_ID, method,
                                svc.EchoReq("go"), svc.EchoRsp,
                                bulk_iovs=iovs)

    def test_segments_both_ways(self, pair):
        segs = [b"alpha", b"", b"gamma" * 100]
        rsp, out = self.bulk(pair, segs)
        assert rsp.text == "segs=3"
        assert [bytes(s) for s in out] == [s[::-1] for s in segs]
        rsp, out = self.bulk(pair, ())
        assert (rsp.text, out) == ("segs=0", [])

    def test_large_and_memoryview_segments(self, pair):
        import numpy as np

        rng = np.random.default_rng(15)
        segs = [rng.integers(0, 256, 2 << 20, dtype=np.uint8).tobytes()
                for _ in range(3)]
        rsp, out = self.bulk(pair, segs)
        assert [bytes(s) for s in out] == [s[::-1] for s in segs]
        mv = memoryview(bytes(range(256)) * 64)
        rsp, out = self.bulk(pair, [mv[0:1000], mv[1000:5000]])
        assert rsp.text == "segs=2"
        assert [bytes(s) for s in out] == [bytes(mv[0:1000])[::-1],
                                           bytes(mv[1000:5000])[::-1]]

    def test_inline_call_and_bulk_to_plain_method(self, pair):
        server, client, cpkg = pair
        assert echo(client, cpkg, server.address, "go",
                    service=BULK_SERVICE_ID).text == "inline"
        Code = mod(cpkg, "utils.result").Code
        assert code_of(cpkg, lambda: self.bulk(pair, [b"data"], method=2)) \
            == Code.RPC_BAD_REQUEST


def _port_native_server():
    _, server = new_server("port-native")
    mod("tpu3fs_torch", "rpc.services").bind_core_service(server)
    bind_bulk("tpu3fs_torch", server)
    return server


@pytest.mark.parametrize("client_name", list(SERVERS))
def test_malformed_frames_do_not_kill_the_server(client_name):
    """A frame whose string-length varint decodes huge, and a bulk
    section that lies about its segment lengths (either package's
    envelope), leave the port's native server serving."""
    server = _port_native_server()
    server.start()
    cpkg, client = new_client(client_name)
    try:
        net = mod(cpkg, "rpc.net")
        pkt = net.MessagePacket(
            uuid="x" * 32, service_id=BULK_SERVICE_ID, method_id=1,
            flags=net.FLAG_IS_REQ | net.FLAG_BULK, status=0, payload=b"")
        frames = [bytes([8]) + b"\xff" * 9 + b"\x01",
                  mod(cpkg, "rpc.serde").serialize(pkt)
                  + bytes([1, 100]) + b"abc"]
        for evil in frames:
            with socket.create_connection(server.address, timeout=2) as s:
                s.sendall(struct.pack(">I", len(evil)) + evil)
        assert echo(client, cpkg, server.address, "alive").text == "alive"
    finally:
        client.close()
        server.stop()


@pytest.mark.parametrize("client_name", ["jax-py", "jax-native",
                                         "port-native"])
def test_many_threads_on_the_port_server(client_name):
    _, server = new_server("port-native")
    mod("tpu3fs_torch", "rpc.services").bind_core_service(server)
    server.start()
    errors = []

    def hammer(tid):
        cpkg, client = new_client(client_name)
        try:
            for i in range(30):
                text = f"t{tid}.{i}" * 100
                assert echo(client, cpkg, server.address, text).text == text
        except BaseException as e:  # reported below
            errors.append(e)
        finally:
            client.close()

    threads = [threading.Thread(target=hammer, args=(t,)) for t in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
    finally:
        server.stop()


def test_dispatch_gated_until_start():
    _, server = new_server("port-native")
    mod("tpu3fs_torch", "rpc.services").bind_core_service(server)
    cpkg, client = new_client("jax-py")
    try:
        Code = mod(cpkg, "utils.result").Code
        assert code_of(cpkg, lambda: echo(client, cpkg, server.address,
                                          "x")) == Code.SHUTTING_DOWN
        server.start()
        assert echo(client, cpkg, server.address, "now").text == "now"
    finally:
        client.close()
        server.stop()


@pytest.mark.parametrize("client_name", ["jax-native", "port-native"])
def test_meta_service_on_the_port_transport(client_name):
    """The whole meta service binds onto the port's native server, and a
    native client of either package drives it."""
    from tpu3fs_torch.kv import MemKVEngine
    from tpu3fs_torch.meta.store import ChainAllocator, MetaStore
    from tpu3fs_torch.rpc.services import bind_meta_service

    store = MetaStore(MemKVEngine(), ChainAllocator(1, [101, 102]))
    _, server = new_server("port-native")
    bind_meta_service(server, store)
    server.start()
    cpkg, client = new_client(client_name)
    try:
        meta = mod(cpkg, "rpc.services").MetaRpcClient([server.address],
                                                       client=client)
        meta.mkdirs("/a", recursive=True)
        res = meta.create("/a/f")
        assert meta.stat("/a/f").id == res.inode.id
        assert [e.name for e in meta.list_dir("/a")] == ["f"]
    finally:
        client.close()
        server.stop()


def test_port_client_timeouts_and_hostnames():
    import time

    server = _port_native_server()
    server.start()
    from tpu3fs_torch.rpc.native_net import NativeRpcClient
    from tpu3fs_torch.utils.result import FsError

    client = NativeRpcClient(connect_timeout=0.3, call_timeout=30.0)
    try:
        assert echo(client, "tpu3fs_torch", ("localhost", server.port),
                    "dns").text == "dns"
        t0 = time.monotonic()
        with pytest.raises(FsError):
            # a closed port on loopback: refused at once
            echo(client, "tpu3fs_torch", ("127.0.0.1", 1), "x")
        assert time.monotonic() - t0 < 5.0
    finally:
        client.close()
        server.stop()


def test_port_library_is_its_own():
    """The port's transport binds the library built from its own source
    (ABI version 5, the JAX package's), loaded from ``_build/``."""
    from tpu3fs_torch import hostbuild
    from tpu3fs_torch.rpc import native_net

    lib = native_net._load_lib()
    assert lib.tpu3fs_rpc_abi_version() == native_net._ABI_VERSION == 5
    assert lib._name == str(hostbuild.library_path("rpc_net"))


@pytest.mark.parametrize("seed", [15, 1515])
def test_kv_main_on_the_native_transport_answers_as_the_jax_kvd(seed):
    """``kv_main --rpc native``: the port's kvd on its C++ transport
    answers ``test_torch_kv_service``'s seeded Kv RPC sequence with the
    bytes a JAX kvd on the Python transport answers."""
    from test_torch_kv_service import Kvd, _rpc_sequence

    from tpu3fs_torch.bin.kv_main import KvApp
    from tpu3fs_torch.rpc.native_net import NativeRpcServer

    app = KvApp(["--rpc", "native", "--port", "0"], device="cpu")
    app.run_background()
    jax_kvd = Kvd("tpu3fs")
    try:
        assert isinstance(app.server, NativeRpcServer)
        got = _rpc_sequence((app.info.hostname, app.info.port), seed)
        assert got == _rpc_sequence(jax_kvd.addr, seed)
    finally:
        app.stop()
        assert app.join(10.0)
        jax_kvd.stop()
