"""The stub factory and the in-memory storage client double
(``client/{stubs,inmem}.py``): ``tests/test_stubs.py``'s cases, run over
both packages (the port's ``StubFactory("inmem")`` and
``StorageClientInMem`` against the JAX package's), with equal replies,
and the port's "native" transport handing out the C++ client. The same
consumer code (``FileIoClient``) runs on the double."""

import importlib

import pytest

PKGS = ("tpu3fs", "tpu3fs_torch")


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(params=PKGS)
def pkg(request):
    return request.param


def _chunk_roundtrip(pkg):
    c = mod(pkg, "client.inmem").StorageClientInMem()
    ChunkId = mod(pkg, "storage.types").ChunkId
    out = []
    r = c.write_chunk(7, ChunkId(1, 0), 0, b"hello", chunk_size=4096)
    out.append((r.ok, r.commit_ver, r.checksum.value))
    r2 = c.write_chunk(7, ChunkId(1, 0), 5, b" world", chunk_size=4096)
    out.append((r2.commit_ver, r2.checksum.value))
    got = c.read_chunk(7, ChunkId(1, 0))
    out.append((got.ok, got.data, got.checksum.value))
    out.append(int(c.read_chunk(7, ChunkId(9, 9)).code))
    out.append(int(c.write_chunk(7, ChunkId(1, 1), 4090, b"xxxxxxxx",
                                 chunk_size=4096).code))
    for i in range(3):
        c.write_chunk(5, ChunkId(42, i), 0, bytes([i]) * 100,
                      chunk_size=4096)
    out.append(c.query_last_chunk(5, 42))
    out.append(c.truncate_file_chunks(5, 42, 1, 40))
    out.append(c.query_last_chunk(5, 42))
    out.append(c.remove_file_chunks(5, 42))
    out.append(c.query_last_chunk(5, 42))
    out.append(c.space_info().chunk_count)
    return out


def test_inmem_client_replies_equal():
    assert _chunk_roundtrip("tpu3fs_torch") == _chunk_roundtrip("tpu3fs")
    got = _chunk_roundtrip("tpu3fs_torch")
    assert got[0][:2] == (True, 1) and got[2][1] == b"hello world"


def test_file_io_client_runs_on_the_double(pkg):
    """FileIoClient moves bytes through the double as through the fabric
    client: multi-chunk writes, reads and the length query."""
    types = mod(pkg, "meta.types")
    fio = mod(pkg, "client.file_io").FileIoClient(
        mod(pkg, "client.inmem").StorageClientInMem())
    layout = types.Layout(table_id=1, chains=[11, 12], chunk_size=1024)
    inode = types.Inode(id=77, type=types.InodeType.FILE, acl=types.Acl(),
                        layout=layout)
    payload = bytes(range(256)) * 10  # 2560 bytes -> 3 chunks
    try:
        assert fio.write(inode, 0, payload) == len(payload)
        assert fio.read(inode, 0, len(payload)) == payload
        assert fio.file_length(inode) >= len(payload)
    finally:
        fio.close()


def test_inmem_stubs(pkg):
    stubs = mod(pkg, "client.stubs").StubFactory(transport="inmem")
    sc = stubs.storage_client()
    assert isinstance(sc, mod(pkg, "client.inmem").StorageClientInMem)
    meta = stubs.meta_client()
    res = meta.create("/f", client_id="t")
    assert meta.stat("/f").id == res.inode.id
    assert stubs.meta_client().stat("/f").id == res.inode.id  # one KV
    FsError = mod(pkg, "utils.result").FsError
    for call in (stubs.rpc_client, stubs.mgmtd_client,
                 stubs.serving_peer_client):
        with pytest.raises(FsError):
            call()


def test_unknown_transport_rejected(pkg):
    with pytest.raises(mod(pkg, "utils.result").FsError):
        mod(pkg, "client.stubs").StubFactory(transport="quic")


def test_port_native_transport_builds_and_serves():
    """The native transport, which raised until it was ported, builds the
    port's C++ client (as the JAX package's builds its own) and serves."""
    from tpu3fs_torch.rpc.net import RpcServer
    from tpu3fs_torch.rpc.services import bind_core_service

    server = RpcServer()
    bind_core_service(server)
    server.start()
    got = {}
    try:
        for pkg in PKGS:
            stubs = mod(pkg, "client.stubs").StubFactory(transport="native")
            client = stubs.rpc_client()
            assert type(client) is mod(pkg, "rpc.native_net").NativeRpcClient
            svc = mod(pkg, "rpc.services")
            got[pkg] = client.call(server.address, svc.CORE_SERVICE_ID, 1,
                                   svc.EchoReq("native"), svc.EchoRsp).text
            stubs.close()
    finally:
        server.stop()
    assert got == {pkg: "native" for pkg in PKGS}
