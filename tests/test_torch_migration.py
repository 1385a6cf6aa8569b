"""The migration service and worker in the port, on the CPU, against the
JAX package's. Tolerance 0: replies, chain tables and chunk bytes must be
equal.

Each case of ``tests/test_migration.py`` runs over both packages (the JAX
package's ``tpu3fs.migration`` on its ``Fabric()``, the port's
``tpu3fs_torch.migration`` on ``Fabric(cfg, device="cpu")``): CR moves
(a join, the quorum kept at every step with foreground writes landing, a
pure capacity add), crash resume (a worker killed mid-plan, the
destination killed mid-copy), the EC shard swap and its rebuild, the EC
direct copy and its decode fallback, the drain CLI, the retire pass and
the auto re-plan. The chain-to-chain ``MigrationService`` (the CLI's
``migrate-start``) is run over both too. Then one parity case: the same
seeded layout and move plan on both packages leaves the same jobs, the
same chain tables and the same chunk bytes on every target."""

import importlib
from types import SimpleNamespace

import pytest

PACKAGES = ["tpu3fs", "tpu3fs_torch"]


def _pkg(root: str) -> SimpleNamespace:
    mods = {name: importlib.import_module(f"{root}.{path}") for name, path in (
        ("cli", "cli"), ("fabric", "fabric.fabric"),
        ("migration", "migration"), ("mtypes", "mgmtd.types"),
        ("stypes", "storage.types"), ("placement", "placement"),
        ("ec_resync", "storage.ec_resync"))}
    return SimpleNamespace(root=root, **mods)


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return _pkg(request.param)


def _fabric(pkg, **cfg):
    return pkg.fabric.Fabric(
        pkg.fabric.SystemSetupConfig(**cfg),
        **({"device": "cpu"} if pkg.root == "tpu3fs_torch" else {}))


def _write_oracle(pkg, fab, per_chain=4, size=512, tag=0):
    client = fab.storage_client()
    oracle = {}
    for c, chain in enumerate(fab.chain_ids):
        for i in range(per_chain):
            data = bytes([(tag + c * 16 + i) % 256]) * size
            r = client.write_chunk(chain, pkg.stypes.ChunkId(100 + c, i), 0,
                                   data, chunk_size=4096)
            assert r.ok, (chain, i, r)
            oracle[(chain, 100 + c, i)] = data
    return oracle


def _verify_oracle(pkg, fab, oracle):
    client = fab.storage_client()
    for (chain, fid, i), data in oracle.items():
        rep = client.read_chunk(chain, pkg.stypes.ChunkId(fid, i))
        assert rep.ok, (chain, fid, i, rep.code)
        assert bytes(rep.data) == data, (chain, fid, i)


def _worker(pkg, fab, wid="w1", **kw):
    return pkg.migration.MigrationWorker(fab.mgmtd, fab.storage_client(),
                                         worker_id=wid, **kw)


def _serving(pkg, chain) -> bool:
    return all(t.public_state == pkg.mtypes.PublicTargetState.SERVING
               for t in chain.targets)


def _move(pkg, **kw):
    return pkg.migration.MoveSpec(**kw)


class TestCrMove:
    def test_join_move_end_to_end_worker_copies(self, pkg):
        fab = _fabric(pkg, num_storage_nodes=3, num_chains=3, num_replicas=2,
                      chunk_size=4096)
        oracle = _write_oracle(pkg, fab)
        nid = fab.add_storage_node()
        cid = fab.chain_ids[0]
        out = fab.routing().chains[cid].targets[0].target_id
        fab.mgmtd.migration_submit(
            [_move(pkg, chain_id=cid, out_target=out, dst_node=nid)])
        w = _worker(pkg, fab)
        done = w.run_until_idle(
            tick=lambda: fab.elastic_tick(resync=False), rounds=60)
        assert done == 1
        job = fab.mgmtd.migration_list()[0]
        assert job.phase == pkg.migration.JobPhase.DONE
        assert job.copied_chunks == 4 and job.copied_bytes == 4 * 512
        chain = fab.routing().chains[cid]
        ids = [t.target_id for t in chain.targets]
        assert out not in ids and job.new_target in ids
        assert _serving(pkg, chain)
        _verify_oracle(pkg, fab, oracle)

    def test_quorum_never_dips_and_fg_writes_land_mid_move(self, pkg):
        fab = _fabric(pkg, num_storage_nodes=3, num_chains=2, num_replicas=2,
                      chunk_size=4096)
        _write_oracle(pkg, fab)
        nid = fab.add_storage_node()
        cid = fab.chain_ids[0]
        out = fab.routing().chains[cid].targets[0].target_id
        fab.mgmtd.migration_submit(
            [_move(pkg, chain_id=cid, out_target=out, dst_node=nid)])
        w = _worker(pkg, fab)
        client = fab.storage_client()
        late = {}
        serving_state = pkg.mtypes.PublicTargetState.SERVING
        for round_no in range(40):
            w.run_once()
            fab.elastic_tick(resync=False)
            for chain in fab.routing().chains.values():
                serving = sum(1 for t in chain.targets
                              if t.public_state == serving_state)
                assert serving >= 2, (round_no, chain.chain_id, serving)
            data = bytes([round_no % 256]) * 64
            r = client.write_chunk(cid, pkg.stypes.ChunkId(200, round_no), 0,
                                   data, chunk_size=4096)
            assert r.ok, (round_no, r.code)
            late[round_no] = data
            if not any(j.active for j in fab.mgmtd.migration_list()):
                break
        assert fab.mgmtd.migration_list()[0].phase \
            == pkg.migration.JobPhase.DONE
        fab.retire_unassigned_targets()
        c2 = fab.storage_client()
        for i, data in late.items():
            rep = c2.read_chunk(cid, pkg.stypes.ChunkId(200, i))
            assert rep.ok and bytes(rep.data) == data

    def test_pure_capacity_add(self, pkg):
        fab = _fabric(pkg, num_storage_nodes=2, num_chains=1, num_replicas=2,
                      chunk_size=4096)
        oracle = _write_oracle(pkg, fab, per_chain=3)
        nid = fab.add_storage_node()
        cid = fab.chain_ids[0]
        fab.mgmtd.migration_submit([_move(pkg, chain_id=cid, dst_node=nid)])
        w = _worker(pkg, fab)
        assert w.run_until_idle(
            tick=lambda: fab.elastic_tick(resync=False), rounds=60) == 1
        chain = fab.routing().chains[cid]
        assert len(chain.targets) == 3 and _serving(pkg, chain)
        _verify_oracle(pkg, fab, oracle)


class TestCrashResume:
    def test_worker_killed_mid_plan_second_worker_resumes(self, pkg):
        JobPhase = pkg.migration.JobPhase
        fab = _fabric(pkg, num_storage_nodes=3, num_chains=2, num_replicas=2,
                      chunk_size=4096)
        oracle = _write_oracle(pkg, fab, per_chain=6)
        nid = fab.add_storage_node()
        specs = []
        for cid in fab.chain_ids:
            out = fab.routing().chains[cid].targets[0].target_id
            specs.append(_move(pkg, chain_id=cid, out_target=out,
                               dst_node=nid))
        fab.mgmtd.migration_submit(specs)
        w1 = _worker(pkg, fab, "w1", batch_chunks=2, lease_s=20)
        for _ in range(4):
            w1.run_once()
            fab.elastic_tick(resync=False)
        mid = {j.job_id: JobPhase(j.phase)
               for j in fab.mgmtd.migration_list()}
        assert any(p in (JobPhase.PREPARED, JobPhase.COPYING, JobPhase.SYNCED)
                   for p in mid.values())
        fab.clock.advance(21)
        w2 = _worker(pkg, fab, "w2", batch_chunks=2, lease_s=20)
        done = w2.run_until_idle(
            tick=lambda: fab.elastic_tick(resync=False), rounds=80)
        assert done == len(fab.chain_ids)
        for chain in fab.routing().chains.values():
            assert _serving(pkg, chain)
        _verify_oracle(pkg, fab, oracle)
        jobs = fab.mgmtd.migration_list()
        w1.run_once()
        assert [(j.job_id, j.phase) for j in fab.mgmtd.migration_list()] \
            == [(j.job_id, j.phase) for j in jobs]

    def test_destination_node_killed_mid_copy(self, pkg):
        JobPhase = pkg.migration.JobPhase
        fab = _fabric(pkg, num_storage_nodes=3, num_chains=1, num_replicas=2,
                      chunk_size=4096, heartbeat_timeout_s=30)
        oracle = _write_oracle(pkg, fab, per_chain=6)
        nid = fab.add_storage_node()
        cid = fab.chain_ids[0]
        out = fab.routing().chains[cid].targets[0].target_id
        fab.mgmtd.migration_submit(
            [_move(pkg, chain_id=cid, out_target=out, dst_node=nid)])
        w = _worker(pkg, fab, batch_chunks=2)
        for _ in range(3):
            w.run_once()
            fab.elastic_tick(resync=False)
        assert JobPhase(fab.mgmtd.migration_list()[0].phase) in (
            JobPhase.COPYING, JobPhase.SYNCED)
        fab.fail_node(nid)
        for _ in range(3):
            w.run_once()
            fab.tick()
        assert fab.mgmtd.migration_list()[0].active
        fab.restart_node(nid)
        done = w.run_until_idle(
            tick=lambda: fab.elastic_tick(resync=False), rounds=80)
        assert done == 1
        assert _serving(pkg, fab.routing().chains[cid])
        _verify_oracle(pkg, fab, oracle)


class TestEcMove:
    def test_shard_swap_rebuild_end_to_end(self, pkg):
        ChunkId = pkg.stypes.ChunkId
        fab = _fabric(pkg, num_storage_nodes=4, num_chains=2, ec_k=2, ec_m=1,
                      chunk_size=1 << 12)
        client = fab.storage_client()
        cid = fab.chain_ids[0]
        stripes = {}
        for i in range(4):
            data = bytes([i + 1]) * (1 << 12)
            replies = client.write_stripes(cid, [(ChunkId(300, i), data)],
                                           chunk_size=1 << 12)
            assert all(r.ok for r in replies)
            stripes[i] = data
        nid = fab.add_storage_node()
        out = fab.routing().chains[cid].preferred_order[1]
        fab.mgmtd.migration_submit(
            [_move(pkg, chain_id=cid, out_target=out, dst_node=nid)])
        w = _worker(pkg, fab)
        done = w.run_until_idle(
            tick=lambda: fab.elastic_tick(resync=True), rounds=80)
        assert done == 1
        chain = fab.routing().chains[cid]
        new_target = chain.preferred_order[1]
        assert new_target != out
        assert fab.routing().targets[new_target].node_id == nid
        assert _serving(pkg, chain)
        c2 = fab.storage_client()
        for i, data in stripes.items():
            rep = c2.read_stripe(cid, ChunkId(300, i), chunk_size=1 << 12)
            assert rep.ok and bytes(rep.data) == data


class TestEcDirectCopy:
    def _setup(self, pkg, stripes=6):
        ChunkId = pkg.stypes.ChunkId
        fab = _fabric(pkg, num_storage_nodes=4, num_chains=2, ec_k=2, ec_m=1,
                      chunk_size=1 << 12)
        client = fab.storage_client()
        cid = fab.chain_ids[0]
        data_of = {}
        for i in range(stripes):
            data = bytes([i + 1]) * (1 << 12)
            assert all(r.ok for r in client.write_stripes(
                cid, [(ChunkId(300, i), data)], chunk_size=1 << 12))
            data_of[i] = data
        nid = fab.add_storage_node()
        out = fab.routing().chains[cid].preferred_order[1]
        fab.mgmtd.migration_submit(
            [_move(pkg, chain_id=cid, out_target=out, dst_node=nid)])
        return fab, cid, out, nid, data_of

    def _drive(self, pkg, fab, rounds=40):
        kw = {"device": "cpu"} if pkg.root == "tpu3fs_torch" else {}
        w = _worker(pkg, fab, batch_chunks=16)
        workers = {}

        def tick():
            fab.open_assigned_targets()
            fab.tick()
            for n, node in fab.nodes.items():
                if node.alive:
                    workers.setdefault(n, pkg.ec_resync.EcResyncWorker(
                        node.service, fab.send, **kw)).run_once()
            fab.tick()

        for _ in range(rounds):
            if w.run_once() == 0 and not any(
                    j.active for j in fab.mgmtd.migration_list()):
                break
            tick()
        sources = {}
        for wk in workers.values():
            for t, c in wk.last_stats["read_sources"].items():
                sources[t] = sources.get(t, 0) + c
        return sources

    def _read_back(self, pkg, fab, cid, data_of):
        c2 = fab.storage_client()
        for i, data in data_of.items():
            rep = c2.read_stripe(cid, pkg.stypes.ChunkId(300, i),
                                 chunk_size=1 << 12)
            assert rep.ok and bytes(rep.data) == data

    def test_alive_outgoing_moves_one_read_per_stripe(self, pkg):
        fab, cid, out, nid, data_of = self._setup(pkg)
        sources = self._drive(pkg, fab)
        assert sources == {out: len(data_of)}, sources
        ri = fab.routing()
        assert ri.targets[out].chain_id == 0
        out_node = ri.targets[out].node_id
        fab.retire_unassigned_targets()
        assert all(t.target_id != out
                   for t in fab.nodes[out_node].service.targets())
        self._read_back(pkg, fab, cid, data_of)
        fab.close()

    def test_dead_outgoing_falls_back_to_decode(self, pkg):
        fab, cid, out, nid, data_of = self._setup(pkg)
        fab.fail_node(fab.routing().targets[out].node_id)
        sources = self._drive(pkg, fab, rounds=60)
        assert sources.get(out, 0) == 0, sources
        assert sum(sources.values()) >= len(data_of), sources
        assert _serving(pkg, fab.routing().chains[cid])
        self._read_back(pkg, fab, cid, data_of)
        fab.close()


class TestDrainCli:
    def test_drain_to_zero_chains(self, pkg):
        fab = _fabric(pkg, num_storage_nodes=4, num_chains=4, num_replicas=2,
                      chunk_size=4096)
        oracle = _write_oracle(pkg, fab)
        cli = pkg.cli.AdminCli(fab)
        out = cli.run("drain --node 10 --apply")
        assert "submitted jobs" in out, out
        _worker(pkg, fab).run_until_idle(
            tick=lambda: fab.elastic_tick(resync=False), rounds=120)
        hosting = [t for t in fab.routing().targets.values()
                   if t.chain_id and t.node_id == 10]
        assert hosting == []
        fab.retire_unassigned_targets()
        assert fab.nodes[10].service.targets() == []
        _verify_oracle(pkg, fab, oracle)
        status = cli.run("migrate-status")
        assert "DONE" in status and "PENDING" not in status

    def test_drain_refused_below_quorum_rolls_back(self, pkg):
        fab = _fabric(pkg, num_storage_nodes=2, num_chains=2, num_replicas=2,
                      chunk_size=4096)
        out = pkg.cli.AdminCli(fab).run("drain --node 10 --apply")
        assert "submitted jobs" not in out
        assert not fab.routing().nodes[10].tags.get("draining")

    def test_drain_refused_when_chain_degraded(self, pkg):
        fab = _fabric(pkg, num_storage_nodes=3, num_chains=2, ec_k=2, ec_m=1,
                      chunk_size=1 << 12)
        fab.add_storage_node()
        cid = fab.chain_ids[0]
        victim = fab.routing().node_of_target(
            fab.routing().chains[cid].targets[0].target_id).node_id
        fab.fail_node(victim)
        other = fab.routing().targets[
            fab.routing().chains[cid].targets[1].target_id].node_id
        out = pkg.cli.AdminCli(fab).run(f"drain --node {other} --apply")
        assert "refused" in out and "ROLLED BACK" in out
        assert not fab.routing().nodes[other].tags.get("draining")


class TestRetirePass:
    def test_unassigned_target_dropped_and_closed(self, pkg):
        fab = _fabric(pkg, num_storage_nodes=3, num_chains=1, num_replicas=2,
                      chunk_size=4096)
        _write_oracle(pkg, fab, per_chain=2)
        nid = fab.add_storage_node()
        cid = fab.chain_ids[0]
        out = fab.routing().chains[cid].targets[0].target_id
        out_node = fab.routing().targets[out].node_id
        fab.mgmtd.migration_submit(
            [_move(pkg, chain_id=cid, out_target=out, dst_node=nid)])
        _worker(pkg, fab).run_until_idle(
            tick=lambda: fab.elastic_tick(resync=False), rounds=60)
        assert fab.nodes[out_node].service.target(out) is None


class TestAutoReplan:
    @staticmethod
    def _drain_two(pkg, fab):
        pl = pkg.placement
        for n in (10, 11):
            fab.mgmtd.set_node_tags(n, {pl.DRAINING_TAG: "1"})
        routing = fab.routing()
        delta = pl.TopologyDelta(draining=[10, 11])
        plan = pl.plan_rebalance(routing, delta)
        assert not plan.empty and not pl.check_plan(routing, plan, delta)
        assert plan.deferred_chains, "fixture must have a 2-loss chain"
        fab.mgmtd.migration_submit([mv.spec() for mv in plan.moves])
        return plan

    def test_two_member_drain_converges_unattended(self, pkg):
        fab = _fabric(pkg, num_storage_nodes=4, num_chains=4, num_replicas=2,
                      chunk_size=4096)
        oracle = _write_oracle(pkg, fab)
        wave1 = self._drain_two(pkg, fab)
        _worker(pkg, fab, auto_replan=True).run_until_idle(
            tick=lambda: fab.elastic_tick(resync=False), rounds=200)
        ri = fab.routing()
        for node in (10, 11):
            hosting = [t for t in ri.targets.values()
                       if t.chain_id and t.node_id == node]
            assert hosting == [], (node, hosting)
        assert all(_serving(pkg, c) for c in ri.chains.values())
        _verify_oracle(pkg, fab, oracle)
        jobs = fab.mgmtd.migration_list()
        assert all(j.phase == pkg.migration.JobPhase.DONE for j in jobs)
        assert len(jobs) > len(wave1.moves)

    def test_disabled_worker_stops_after_one_wave(self, pkg):
        fab = _fabric(pkg, num_storage_nodes=4, num_chains=4, num_replicas=2,
                      chunk_size=4096)
        _write_oracle(pkg, fab)
        plan = self._drain_two(pkg, fab)
        _worker(pkg, fab, auto_replan=False).run_until_idle(
            tick=lambda: fab.elastic_tick(resync=False), rounds=200)
        left = [t for t in fab.routing().targets.values()
                if t.chain_id and t.node_id in (10, 11)]
        assert left, "one-wave worker should leave the deferred member"
        assert len(fab.mgmtd.migration_list()) == len(plan.moves)

    def test_never_initiates_without_operator_jobs(self, pkg):
        fab = _fabric(pkg, num_storage_nodes=3, num_chains=2, num_replicas=2,
                      chunk_size=4096)
        fab.mgmtd.set_node_tags(10, {pkg.placement.DRAINING_TAG: "1"})
        w = _worker(pkg, fab, auto_replan=True)
        assert w.maybe_replan() == 0
        w.run_once()
        assert fab.mgmtd.migration_list() == []

    def test_replan_uses_joined_node_as_destination(self, pkg):
        fab = _fabric(pkg, num_storage_nodes=3, num_chains=1, num_replicas=3,
                      chunk_size=4096)
        oracle = _write_oracle(pkg, fab)
        nid = fab.add_storage_node()
        cid = fab.chain_ids[0]
        w = _worker(pkg, fab, auto_replan=True)

        def settle():
            w.run_until_idle(tick=lambda: fab.elastic_tick(resync=False),
                             rounds=200)

        def member_on(node):
            return next(t.target_id for t in fab.routing().chains[cid].targets
                        if fab.routing().targets[t.target_id].node_id == node)

        fab.mgmtd.migration_submit([_move(
            pkg, chain_id=cid, out_target=member_on(12), dst_node=nid)])
        settle()
        fab.mgmtd.migration_submit([_move(
            pkg, chain_id=cid, out_target=member_on(nid), dst_node=12)])
        settle()
        fab.retire_unassigned_targets()
        fab.mgmtd.set_node_tags(10, {pkg.placement.DRAINING_TAG: "1"})
        assert w.maybe_replan() > 0
        settle()
        ri = fab.routing()
        assert [t for t in ri.targets.values()
                if t.chain_id and t.node_id == 10] == []
        members = {ri.targets[t.target_id].node_id
                   for t in ri.chains[cid].targets}
        assert members == {11, 12, nid}
        assert _serving(pkg, ri.chains[cid])
        _verify_oracle(pkg, fab, oracle)


class TestMigrationService:
    """The chain-to-chain copy service behind ``migrate-start``,
    ``migrate-list`` and ``migrate-stop``."""

    def test_copy_chain_through_the_cli(self, pkg):
        fab = _fabric(pkg, num_storage_nodes=3, num_chains=2, num_replicas=2,
                      chunk_size=4096)
        oracle = _write_oracle(pkg, fab, per_chain=5)
        src, dst = fab.chain_ids
        cli = pkg.cli.AdminCli(fab)
        assert cli.run(f"migrate-start {src} {dst}") \
            == "job 1: done copied=5/5"
        assert cli.run("migrate-list") == f"job 1: {src}->{dst} done 5/5"
        assert cli.run("migrate-stop 1") == "not running"
        client = fab.storage_client()
        for (chain, fid, i), data in oracle.items():
            if chain == src:
                rep = client.read_chunk(dst, pkg.stypes.ChunkId(fid, i))
                assert rep.ok and bytes(rep.data) == data


LAYOUTS = {"cr": dict(num_storage_nodes=4, num_chains=3, num_replicas=2,
                     chunk_size=4096),
           "ec": dict(num_storage_nodes=4, num_chains=3, ec_k=2, ec_m=1,
                      chunk_size=4096)}


def _layout_run(pkg, layout: str) -> dict:
    """One seeded layout and move plan: 3 chains (CR of 2 or EC(2,1)) over
    4 nodes with seeded chunks (CR) or stripes (EC), a node joined, the
    second member of two chains moved onto it, the worker run to idle
    (an EC move's shard copied directly or rebuilt by the storage side).
    -> the jobs, the chain tables and every target's committed chunks
    (version, CRC, bytes) as target-addressed reads return them."""
    import numpy as np

    ChunkId = pkg.stypes.ChunkId
    ReadReq = importlib.import_module(f"{pkg.root}.storage.craq").ReadReq
    ec = layout == "ec"
    rng = np.random.default_rng(16)
    fab = _fabric(pkg, **LAYOUTS[layout])
    client = fab.storage_client()
    for c, chain in enumerate(fab.chain_ids):
        for i in range(5):
            n = 4096 if ec else int(rng.integers(1, 4096))
            data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            if ec:
                replies = client.write_stripes(
                    chain, [(ChunkId(500 + c, i), data)], chunk_size=4096)
                assert all(r.ok for r in replies)
            else:
                assert client.write_chunk(chain, ChunkId(500 + c, i), 0,
                                          data, chunk_size=4096).ok
    nid = fab.add_storage_node()
    specs = []
    for cid in fab.chain_ids[:2]:
        out = fab.routing().chains[cid].targets[1].target_id
        specs.append(_move(pkg, chain_id=cid, out_target=out, dst_node=nid))
    ids = fab.mgmtd.migration_submit(specs)
    done = _worker(pkg, fab).run_until_idle(
        tick=lambda: fab.elastic_tick(resync=ec), rounds=80)
    fab.retire_unassigned_targets()
    ri = fab.routing()
    jobs = [(j.job_id, j.chain_id, j.out_target, j.new_target, j.dst_node,
             int(j.phase), j.copied_chunks, j.copied_bytes)
            for j in fab.mgmtd.migration_list()]
    chains = {c.chain_id: (c.chain_version,
                           [(t.target_id, int(t.public_state))
                            for t in c.targets])
              for c in ri.chains.values()}
    stored = {}
    for node_id, node in fab.nodes.items():
        for target in node.service.targets():
            tid = target.target_id
            metas = fab.send(node_id, "dump_chunkmeta", tid)
            reps = fab.send(node_id, "batch_read", [
                ReadReq(target.chain_id, m.chunk_id, 0, -1, target_id=tid)
                for m in metas])
            for m, rep in zip(metas, reps):
                assert rep.ok, (node_id, tid, m.chunk_id)
                stored[(node_id, tid, m.chunk_id.to_bytes())] = (
                    m.committed_ver, rep.checksum.value, bytes(rep.data))
    return {"ids": ids, "done": done, "jobs": jobs, "chains": chains,
            "stored": stored}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_same_plan_leaves_the_same_tables_and_bytes(layout):
    """The EC stripe versions carry a nonce (``os.urandom``), drawn from
    one seed in both runs."""
    from torch_fabric_sequence import deterministic

    with deterministic(16):
        jax_run = _layout_run(_pkg("tpu3fs"), layout)
    with deterministic(16):
        port_run = _layout_run(_pkg("tpu3fs_torch"), layout)
    assert port_run["done"] == 2 and port_run["stored"]
    assert port_run == jax_run
