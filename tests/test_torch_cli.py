"""The admin CLI in the port, on the CPU, against the JAX package's.
Tolerance 0: replies, stored bytes and chain tables must be equal.

One seeded command script (topology inspection, the FS shell, checksums,
the storage bench, the maintenance sweeps, dumps, the placement solver,
a rebalance preview, the copy service, the checkpoint and KV-cache
views) goes through ``AdminCli`` of both packages over their in-process
fabrics (the port's on ``device="cpu"``); the replies are held equal
after times and durations are masked. The four cases of
``tests/test_cli_rpc.py`` run over the port's sockets with
``RpcFabricView(..., device="cpu")``. ``verify-checksums`` finds the same
corrupted replica in both packages, and the port's ``--data`` sweep finds
a chunk whose bytes were changed behind its stored CRC, an EC shard
included. ``main`` runs one-shot over a live cluster, and the view raises
without a card when no device is asked for."""

import importlib
import io
import re
from contextlib import redirect_stdout
from types import SimpleNamespace

import numpy as np
import pytest
import torch

PACKAGES = ["tpu3fs", "tpu3fs_torch"]


def _pkg(root: str) -> SimpleNamespace:
    mods = {name: importlib.import_module(f"{root}.{path}") for name, path in (
        ("cli", "cli"), ("fabric", "fabric.fabric"), ("stypes", "storage.types"),
        ("store", "meta.store"), ("kv", "kv"), ("mgmtd", "mgmtd.service"),
        ("mtypes", "mgmtd.types"), ("stripe", "ops.stripe"),
        ("net", "rpc.net"), ("services", "rpc.services"),
        ("craq", "storage.craq"), ("target", "storage.target"),
        ("placement", "placement"))}
    return SimpleNamespace(root=root, **mods)


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return _pkg(request.param)


def _dev(pkg) -> dict:
    return {"device": "cpu"} if pkg.root == "tpu3fs_torch" else {}


def _fabric(pkg, **cfg):
    return pkg.fabric.Fabric(pkg.fabric.SystemSetupConfig(**cfg), **_dev(pkg))


# -- one seeded command script through both packages ------------------------
def _script(rng) -> list:
    text = "".join(chr(c) for c in rng.integers(97, 123, 300))
    return [
        "help", "list-nodes", "list-chains", "list-targets",
        "list-chain-tables", "routing-info", "meta-partitions",
        "mkdir -p /a/b", "mkdir /c", f"write /a/b/f {text}",
        "write /a/g hello", "ls /", "ls /a", "stat /a/b/f",
        "read /a/b/f --offset 10 --length 40", "checksum /a/b/f",
        "mv /a/g /c/g", "truncate /c/g 3", "read /c/g", "touch /c/t",
        "stat-fs", "bench --chunks 8 --size 2048", "read-bench --chunks 8",
        "verify-checksums", "find-orphaned-chunks",
        "find-orphaned-chunks --remove", "dump-chains", "dump-chain-table",
        "solve-placement --nodes 6 --group-size 3 --targets-per-node 4 "
        "--steps 30",
        "solve-placement --nodes 8 --group-size 4 --targets-per-node 2 "
        "--steps 20 --ec-k 3 --ec-m 1",
        "placement-plan", "placement-plan --join 20",
        "rebalance --join 20", "migrate-status", "migrate-list",
        "rm /c/t", "rm -r /a", "gc-run", "ls /", "ckpt-list",
        "kvcache-stats", "kvcache-gc --ttl 0", "serving",
        "no-such-command", "stat /missing", "mkdir",
    ]


_MASKS = [
    (re.compile(r"\d+\.\d+"), "F"),                 # durations, rates, times
    (re.compile(r"(?m)^(\d+\s+\w+\s+\w+\s+)\d+$"), r"\1T"),  # list-nodes hb
]


def _mask(out: str) -> str:
    for pat, rep in _MASKS:
        out = pat.sub(rep, out)
    return out


def _run_script(pkg) -> list:
    from torch_fabric_sequence import deterministic

    with deterministic(7):
        fab = _fabric(pkg, num_storage_nodes=4, num_chains=3,
                      chunk_size=4096)
        cli = pkg.cli.AdminCli(fab)
        rng = np.random.default_rng(7)
        return [(line, _mask(cli.run(line))) for line in _script(rng)]


def test_command_script_replies_equal():
    want = _run_script(_pkg("tpu3fs"))
    got = _run_script(_pkg("tpu3fs_torch"))
    assert [line for line, _ in got] == [line for line, _ in want]
    for (line, a), (_, b) in zip(got, want):
        assert a == b, line
    assert "crc32c=0x" in dict(got)["checksum /a/b/f"]


def test_copy_service_commands_equal():
    """``migrate-start``, ``migrate-list`` and ``migrate-stop`` through the
    copy service, the same replies and copied bytes in both packages."""
    out = {}
    for root in PACKAGES:
        pkg = _pkg(root)
        fab = _fabric(pkg, num_chains=2, chunk_size=4096)
        sc = fab.storage_client()
        src, dst = fab.chain_ids
        for i in range(7):
            assert sc.write_chunk(src, pkg.stypes.ChunkId(40, i), 0,
                                  bytes([i]) * (100 + i), chunk_size=4096).ok
        cli = pkg.cli.AdminCli(fab)
        replies = [cli.run(line) for line in (
            f"migrate-start {src} {dst}", "migrate-list", "migrate-stop 1",
            f"migrate-start {src} {src}")]
        copied = [bytes(sc.read_chunk(dst, pkg.stypes.ChunkId(40, i)).data)
                  for i in range(7)]
        out[root] = (replies, copied)
    assert out["tpu3fs_torch"] == out["tpu3fs"]
    assert out["tpu3fs"][0][0] == "job 1: done copied=7/7"


# -- verify-checksums ---------------------------------------------------------
def _corrupt_replica(pkg):
    """test_admin_parity's case: six chunks, then ONE replica's committed
    content replaced behind the protocol."""
    ChunkId = pkg.stypes.ChunkId
    fab = _fabric(pkg, num_chains=2, chunk_size=4096)
    cli = pkg.cli.AdminCli(fab)
    sc = fab.storage_client()
    for i in range(6):
        sc.write_chunk(fab.chain_ids[0], ChunkId(70, i), 0,
                       bytes([i]) * 512, chunk_size=4096)
    clean = cli.run("verify-checksums")
    chain = fab.routing().chains[fab.chain_ids[0]]
    t = chain.targets[-1]
    node = fab.routing().node_of_target(t.target_id)
    eng = fab.nodes[node.node_id].service.target(t.target_id).engine
    eng.update(ChunkId(70, 0), 99, 1, b"CORRUPT", 0, full_replace=True,
               chunk_size=4096)
    return clean, cli.run("verify-checksums"), cli


def test_verify_checksums_finds_the_same_corrupted_replica():
    jax_clean, jax_bad, _ = _corrupt_replica(_pkg("tpu3fs"))
    clean, bad, cli = _corrupt_replica(_pkg("tpu3fs_torch"))
    assert (clean, bad) == (jax_clean, jax_bad)
    assert "6 chunks, 0 mismatches" in clean
    assert "1 mismatches" in bad and "000000000000004600000000" in bad
    # the replica's bytes and its stored CRC agree: --data finds nothing
    assert cli.run("verify-checksums --data").endswith(
        ", 0 data mismatches")


def _flip_stored_byte(fab, tid: int, chunk_id) -> None:
    """Change one byte of a mem engine's committed chunk, leaving its
    stored CRC as it was (bit rot under the checksum)."""
    for node in fab.nodes.values():
        target = node.service.target(tid)
        if target is None:
            continue
        eng = target.engine
        data = bytearray(eng.read(chunk_id))
        data[len(data) // 2] ^= 0x01
        with eng._lock:
            eng._slot(chunk_id).committed = bytes(data)
        return
    raise AssertionError(f"no target {tid}")


@pytest.mark.parametrize("layout", ["cr", "ec"])
def test_verify_data_finds_bytes_changed_under_the_crc(layout, monkeypatch):
    """``verify-checksums --data`` reads every committed chunk of every
    target (each EC shard too), checksums the bytes with ``crc32c_many``
    on the fabric's device, and names the one whose bytes no longer
    match its stored CRC."""
    from tpu3fs_torch.ops import crc32c as crc_mod

    pkg = _pkg("tpu3fs_torch")
    ChunkId = pkg.stypes.ChunkId
    cfg = dict(num_storage_nodes=4, num_chains=2, chunk_size=4096)
    if layout == "ec":
        cfg.update(ec_k=2, ec_m=1)
    fab = _fabric(pkg, **cfg)
    sc = fab.storage_client()
    rng = np.random.default_rng(3)
    cid = fab.chain_ids[0]
    for i in range(5):
        data = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
        if layout == "ec":
            assert all(r.ok for r in sc.write_stripes(
                cid, [(ChunkId(80, i), data)], chunk_size=4096))
        else:
            assert sc.write_chunk(cid, ChunkId(80, i), 0, data,
                                  chunk_size=4096).ok
    calls = []
    real = crc_mod.crc32c_many

    def spy(bufs, device=None):
        calls.append((len(bufs), device))
        return real(bufs, device)

    monkeypatch.setattr(crc_mod, "crc32c_many", spy)
    cli = pkg.cli.AdminCli(fab)
    members = len(fab.routing().chains[cid].targets)
    assert cli.run("verify-checksums --data") \
        == f"read {5 * members} chunks ({5 * members * (4096 if layout == 'cr' else 2048)} bytes), 0 data mismatches"
    assert calls and all(d == torch.device("cpu") for _, d in calls)
    victim = fab.routing().chains[cid].targets[1].target_id
    _flip_stored_byte(fab, victim, ChunkId(80, 3))
    out = cli.run(f"verify-checksums --data --chain {cid}").splitlines()
    assert out[0].endswith(", 1 data mismatches")
    assert out[1].startswith(f"chain {cid} target {victim} chunk "
                             f"{ChunkId(80, 3).to_bytes().hex()}: crc ")


# -- the four cases of test_cli_rpc.py over the port's sockets ---------------
@pytest.fixture
def socket_cluster():
    p = _pkg("tpu3fs_torch")
    mgmtd = p.mgmtd.Mgmtd(1, p.kv.MemKVEngine())
    mgmtd.extend_lease()
    mgmtd_server = p.net.RpcServer()
    svc_def = p.services.bind_mgmtd_service(mgmtd_server, mgmtd)
    p.services.bind_mgmtd_admin(svc_def, mgmtd)
    mgmtd_server.start()
    servers = [mgmtd_server]
    services = {}
    shared = p.net.RpcClient()
    node_ids = [20, 21, 22, 23]
    chunk = 1 << 14
    views = []
    try:
        for node_id in node_ids:
            mcli = p.services.MgmtdRpcClient(mgmtd_server.address, shared)
            svc = p.craq.StorageService(node_id, mcli.refresh_routing,
                                        device="cpu")
            svc.set_messenger(p.services.RpcMessenger(mcli.refresh_routing,
                                                      shared))
            server = p.net.RpcServer()
            p.services.bind_storage_service(server, svc)
            server.start()
            mgmtd.register_node(node_id, p.mtypes.NodeType.STORAGE,
                                host=server.host, port=server.port)
            services[node_id] = svc
            servers.append(server)

        def view(**kw):
            v = p.cli.RpcFabricView(mgmtd_server.address, device="cpu", **kw)
            views.append(v)
            return v

        yield {"p": p, "mgmtd": mgmtd, "mgmtd_addr": mgmtd_server.address,
               "services": services, "node_ids": node_ids, "chunk": chunk,
               "shard": p.stripe.shard_size_of(chunk, 3), "view": view}
    finally:
        for v in views:
            v.close()
        for s in servers:
            s.stop()
        for svc in services.values():
            svc.stop_workers()
        shared.close()


class TestAdminCliOverSockets:
    def test_view_storage_clients_get_unique_wire_ids(self, socket_cluster):
        view = socket_cluster["view"](client_id="dup")
        a = view.storage_client()
        b = view.storage_client()
        assert a.client_id != b.client_id
        view2 = socket_cluster["view"](client_id="dup")
        c2 = view2.storage_client()
        assert c2.client_id not in (a.client_id, b.client_id)
        assert {a.device, b.device, c2.device} == {torch.device("cpu")}
        for c in (a, b, c2):
            c.close()

    def test_ec_chain_created_via_cli_serves_stripes(self, socket_cluster):
        c = socket_cluster
        p = c["p"]
        view = c["view"]()
        cli = p.cli.AdminCli(view)
        chain_id = 910_001
        tids = [3000, 3001, 3002, 3003]
        for node_id, tid in zip(c["node_ids"], tids):
            out = cli.run(f"create-target --target-id {tid} "
                          f"--node-id {node_id}")
            assert "created" in out
            c["services"][node_id].add_target(p.target.StorageTarget(
                tid, chain_id, chunk_size=c["shard"], device="cpu"))
        out = cli.run(
            f"upload-chain --chain-id {chain_id} "
            f"--targets {','.join(map(str, tids))} --ec-k 3 --ec-m 1")
        assert "EC(3,1)" in out
        assert "uploaded" in cli.run(
            f"upload-chain-table --table-id 1 --chains {chain_id}")
        for i, node_id in enumerate(c["node_ids"]):
            c["mgmtd"].heartbeat(node_id, 1, {
                tids[i]: p.mtypes.LocalTargetState.UPTODATE})
        chain = view.routing().chains[chain_id]
        assert chain.is_ec and chain.ec_k == 3 and chain.ec_m == 1
        sc = view.storage_client()
        rng = np.random.default_rng(1)
        data = rng.integers(0, 256, c["chunk"], dtype=np.uint8).tobytes()
        replies = sc.write_stripes(chain_id, [(p.stypes.ChunkId(77, 0), data)],
                                   chunk_size=c["chunk"])
        assert all(r.ok for r in replies)
        got = sc.read_stripe(chain_id, p.stypes.ChunkId(77, 0), 0, c["chunk"],
                             chunk_size=c["chunk"])
        assert got.ok and got.data == data
        # every shard on its target checksums as its engine says
        assert re.fullmatch(r"read 4 chunks \(\d+ bytes\), 0 data mismatches",
                            cli.run("verify-checksums --data"))
        sc.close()

    def test_cli_list_chains_shows_cli_created_cr_chain(self, socket_cluster):
        c = socket_cluster
        p = c["p"]
        cli = p.cli.AdminCli(c["view"]())
        chain_id = 910_002
        tids = [3100, 3101]
        for node_id, tid in zip(c["node_ids"][:2], tids):
            cli.run(f"create-target --target-id {tid} --node-id {node_id}")
            c["services"][node_id].add_target(p.target.StorageTarget(
                tid, chain_id, chunk_size=4096, device="cpu"))
        out = cli.run(f"upload-chain --chain-id {chain_id} "
                      f"--targets {tids[0]},{tids[1]}")
        assert "CR" in out
        assert str(chain_id) in cli.run("list-chains")

    def test_solver_emits_ec_commands_cli_can_execute(self, socket_cluster):
        c = socket_cluster
        p = c["p"]
        cli = p.cli.AdminCli(c["view"]())
        problem = p.placement.PlacementProblem(
            num_nodes=4, group_size=4, targets_per_node=1,
            chain_table_type="EC")
        M = p.placement.solve_placement(problem, steps=5, device="cpu")
        cmds = p.placement.gen_chain_table_commands(
            M, first_target_id=3200, first_chain_id=920_001,
            node_ids=c["node_ids"], ec_k=3, ec_m=1)
        assert any("--ec-k 3 --ec-m 1" in x for x in cmds)
        for cmd in cmds:
            out = cli.run(cmd)
            assert "error" not in out, (cmd, out)
        chain = cli.fab.routing().chains[920_001]
        assert chain.is_ec and chain.ec_k == 3


def test_main_one_shot_over_a_live_cluster(socket_cluster):
    """``python -m tpu3fs_torch.cli --device cpu --connect H:P cmd``:
    the reply printed, the view closed."""
    host, port = socket_cluster["mgmtd_addr"]
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = socket_cluster["p"].cli.main(
            ["--device", "cpu", "--connect", f"{host}:{port}",
             "routing-info"])
    assert rc == 0
    assert buf.getvalue().startswith("version ")
    assert "4 nodes" in buf.getvalue()


def test_solve_placement_scores_on_the_fabric_device(monkeypatch):
    """The solver runs on the fabric's device, and its commands equal
    ``entry.gen_chain_table``'s for the same problem."""
    from tpu3fs_torch import entry
    from tpu3fs_torch.placement import solver

    pkg = _pkg("tpu3fs_torch")
    seen = []
    real = solver.solve_placement

    def spy(*a, **kw):
        seen.append(kw.get("device"))
        return real(*a, **kw)

    monkeypatch.setattr(solver, "solve_placement", spy)
    monkeypatch.setattr(pkg.placement, "solve_placement", spy)
    cli = pkg.cli.AdminCli(_fabric(pkg))
    out = cli.run("solve-placement --nodes 12 --group-size 3 "
                  "--targets-per-node 4 --steps 25")
    assert seen == [torch.device("cpu")]
    assert out.splitlines() == entry.gen_chain_table(
        12, 3, 4, steps=25, device="cpu")


def test_view_without_a_card_or_a_device_raises(socket_cluster):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        socket_cluster["p"].cli.RpcFabricView(socket_cluster["mgmtd_addr"])
