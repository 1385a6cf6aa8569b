"""The port's replicated kvd group (``tpu3fs_torch.kv.replica``), held
against ``tests/test_kv_replica.py``'s scenarios and against the JAX
package's members.

A three-member port group elects one leader, commits at quorum and
answers a follower's client with ``KV_NOT_PRIMARY`` and the leader's id. A
killed leader loses no acknowledged transaction, and the restarted member
catches up to the leader's applied index. A follower whose data directory
is wiped catches up through a snapshot install. Meta transactions
survive a failover, and a fourth member joins by reconfig. A group's Raft
log and snapshot written by one package are read by the other's members
to an equal state, and a group of members of both packages fails over.
Ports are reserved below the ephemeral range, every wait is bounded and
every group is stopped in a ``finally``."""

import shutil
import threading

import pytest

from torch_kvd_group import Group, mod

PORT = "tpu3fs_torch"


@pytest.fixture
def group(tmp_path):
    before = set(threading.enumerate())
    g = Group(tmp_path, {1: PORT, 2: PORT, 3: PORT})
    try:
        yield g
    finally:
        g.stop()
    left = [t.name for t in set(threading.enumerate()) - before
            if t.is_alive() and t.name.startswith("kvd-repl")]
    assert not left, f"Raft threads left: {left}"


def _put(eng, key: bytes, value: bytes, pkg=PORT):
    mod(pkg, "kv.kv").with_transaction(eng, lambda tx: tx.set(key, value))


def _read(eng, keys, pkg=PORT):
    return mod(pkg, "kv.kv").with_transaction(
        eng, lambda tx: {k: tx.get(k) for k in keys})


def _dump(svc):
    return svc.engine.dump_at(svc.engine.version)


def test_elects_commits_at_quorum_and_hints_the_leader(group):
    from tpu3fs_torch.kv.remote import RemoteKVEngine, _leader_hint
    from tpu3fs_torch.kv.replica import KV_REPL_SERVICE_ID, StatusReq, StatusRsp
    from tpu3fs_torch.rpc.net import RpcClient
    from tpu3fs_torch.utils.result import Code, FsError

    leader = group.wait_leader()
    eng = group.client()
    _put(eng, b"hello", b"world")
    assert _read(eng, [b"hello"]) == {b"hello": b"world"}
    # acknowledged means durable on a majority: both followers hold it
    # once their applied index reaches the leader's commit
    index = group.svcs[leader].commit_index
    for i in group.peers:
        group.wait_applied(i, index)
        assert group.svcs[i].engine.read_at(
            b"hello", group.svcs[i].engine.version) == b"world"
    follower = next(i for i in group.peers if i != leader)
    direct = RemoteKVEngine(group.peers[follower])
    with pytest.raises(FsError) as ei:
        direct.transaction()
    assert ei.value.code == Code.KV_NOT_PRIMARY
    assert _leader_hint(ei.value.status.message) == leader
    cli = RpcClient()
    try:
        st = [cli.call(group.peers[i], KV_REPL_SERVICE_ID, 4, StatusReq(),
                       StatusRsp) for i in sorted(group.peers)]
    finally:
        cli.close()
    assert [s.role for s in st].count("leader") == 1
    assert {s.leader_id for s in st} == {leader}
    assert len({s.term for s in st}) == 1


def test_killed_leader_loses_no_acked_txn_and_restart_catches_up(group):
    leader = group.wait_leader()
    eng = group.client()
    acked = []
    for seq in range(40):
        if seq == 12:
            group.kill_node(leader)   # abrupt, mid-stream
        key = b"txn/%04d" % seq
        _put(eng, key, b"v%d" % seq)  # retries across the election
        acked.append(key)
    new_leader = group.wait_leader(exclude=(leader,))
    assert new_leader != leader
    got = _read(group.client(), acked)
    assert [k for k, v in got.items() if v is None] == []
    group.start_node(leader)          # back on its own data directory
    group.wait_applied(leader, group.svcs[new_leader].commit_index)
    assert _dump(group.svcs[leader]) == _dump(group.svcs[new_leader])


def test_wiped_follower_catches_up_from_a_snapshot(tmp_path):
    g = Group(tmp_path, {1: PORT, 2: PORT, 3: PORT}, compact_entries=20)
    try:
        g.wait_leader()
        eng = g.client()
        for seq in range(60):
            _put(eng, b"k%03d" % seq, b"v%d" % seq)
        leader = g.wait_leader()
        assert g.svcs[leader].snap_last_index > 0  # compaction ran
        follower = next(i for i in g.peers if i != leader)
        g.kill_node(follower)
        shutil.rmtree(g.dirs[follower])
        g.start_node(follower)
        g.wait_applied(follower, g.svcs[leader].commit_index)
        svc = g.svcs[follower]
        assert svc.engine.read_at(b"k000", svc.engine.version) == b"v0"
        assert svc.engine.read_at(b"k059", svc.engine.version) == b"v59"
    finally:
        g.stop()


def test_meta_store_survives_kvd_failover(group):
    from tpu3fs_torch.meta.store import MetaStore, OpenFlags

    leader = group.wait_leader()
    store = MetaStore(group.client())
    created = []
    for i in range(16):
        if i == 6:
            group.kill_node(leader)
        res = store.create(f"/f{i}", flags=OpenFlags.WRITE, client_id="c1")
        created.append((f"/f{i}", res.inode.id))
    assert [store.stat(p).id for p, _ in created] == [i for _, i in created]


def test_added_member_catches_up_then_leader_failover(group, tmp_path):
    from tpu3fs_torch.kv.replica import ReconfigReq
    from torch_kvd_group import reserve_group_port

    leader = group.wait_leader()
    eng = group.client()
    for seq in range(8):
        _put(eng, b"pre/%02d" % seq, b"v")
    new_peers = dict(group.svcs[leader].peers)
    new_peers[4] = ("127.0.0.1", reserve_group_port(
        exclude={p for _, p in new_peers.values()}))
    group.peers, group.pkgs[4] = new_peers, PORT
    group.dirs[4] = str(tmp_path / "kvd4")
    group.start_node(4)
    svc = group.svcs[leader]
    rsp = svc.reconfig(ReconfigReq(peers_json=svc._peers_to_json(new_peers)))
    assert rsp.ok, rsp.message
    group.wait_applied(4, rsp.index)
    assert group.svcs[4].peers == new_peers
    for seq in range(8):
        _put(eng, b"post/%02d" % seq, b"v")
    group.kill_node(leader)
    group.wait_leader(exclude=(leader,))
    keys = [b"pre/%02d" % s for s in range(8)] + \
        [b"post/%02d" % s for s in range(8)]
    assert set(_read(group.client(), keys).values()) == {b"v"}


@pytest.mark.parametrize("writer,reader", [("tpu3fs", PORT), (PORT, "tpu3fs")],
                         ids=["jax-files-port-group", "port-files-jax-group"])
def test_log_and_snapshot_read_by_the_other_package(tmp_path, writer, reader):
    """The Raft state, log and snapshot files of one package's group are
    the durable state of the other's members: restarted on them, the
    group serves every acknowledged key, and each member's engine equals
    the writer's."""
    g = Group(tmp_path, {i: writer for i in (1, 2, 3)}, compact_entries=20)
    try:
        g.wait_leader()
        eng = g.client(writer)
        for seq in range(50):
            _put(eng, b"d%03d" % seq, b"v%d" % seq, writer)
        _put(eng, b"d000", b"rewritten", writer)
        leader = g.wait_leader()
        for i in g.peers:
            g.wait_applied(i, g.svcs[leader].commit_index)
        want = _dump(g.svcs[leader])
        assert g.svcs[leader].snap_last_index > 0  # a snapshot was written
    finally:
        g.stop()
    # the leader compacted: its directory holds all three files
    files = {p.name for p in (tmp_path / f"kvd{leader}").iterdir()}
    assert {"raft_state.json", "repl.log", "repl.snap"} <= files
    h = Group(tmp_path, {i: reader for i in (1, 2, 3)}, dirs=g.dirs,
              peers=g.peers, compact_entries=20)
    try:
        leader = h.wait_leader()
        got = _read(h.client(reader), [b"d%03d" % s for s in range(50)],
                    reader)
        assert got[b"d000"] == b"rewritten"
        assert all(got[b"d%03d" % s] == b"v%d" % s for s in range(1, 50))
        for i in h.peers:
            h.wait_applied(i, h.svcs[leader].commit_index)
            assert _dump(h.svcs[i]) == want
    finally:
        h.stop()


def test_group_of_both_packages_fails_over(tmp_path):
    """Members of both packages in one group: the Raft wire (votes,
    appends, snapshots) crosses the packages, and a killed leader loses no
    acknowledged transaction."""
    g = Group(tmp_path, {1: "tpu3fs", 2: PORT, 3: PORT})
    try:
        leader = g.wait_leader()
        eng = g.client()
        acked = []
        for seq in range(24):
            if seq == 8:
                g.kill_node(leader)
            _put(eng, b"mix/%02d" % seq, b"v")
            acked.append(b"mix/%02d" % seq)
        survivor = g.wait_leader(exclude=(leader,))
        assert set(_read(g.client("tpu3fs"), acked, "tpu3fs").values()) \
            == {b"v"}
        g.start_node(leader)
        g.wait_applied(leader, g.svcs[survivor].commit_index)
        assert _dump(g.svcs[leader]) == _dump(g.svcs[survivor])
    finally:
        g.stop()
