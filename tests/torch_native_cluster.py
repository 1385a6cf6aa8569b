"""Native-transport storage nodes of either package in one process, for
``tests/test_torch_native_fastpath.py``: mgmtd on a native server, storage
services with native-engine targets on native servers, one native client
(the shape of ``tests/test_native_fastpath.py``'s fixtures). Imports
nothing of either package until called, so a process may load the JAX
package's libraries first."""

import importlib

CHUNK = 4096
CHAIN = 700_001


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def dev(pkg: str) -> dict:
    return {"device": "cpu"} if pkg == "tpu3fs_torch" else {}


def build(pkg: str, path, node_targets) -> dict:
    """mgmtd + one native storage node a (node_id, target_id) of
    ``node_targets``, the targets one CR chain CHAIN in that order (the
    first is the head); -> the environment ``close`` takes."""
    Mgmtd = mod(pkg, "mgmtd.service").Mgmtd
    types = mod(pkg, "mgmtd.types")
    nn = mod(pkg, "rpc.native_net")
    svcs = mod(pkg, "rpc.services")
    path.mkdir(parents=True, exist_ok=True)
    mgmtd = Mgmtd(1, mod(pkg, "kv.mem").MemKVEngine())
    mgmtd.extend_lease()
    mgmtd_server = nn.NativeRpcServer()
    svcs.bind_mgmtd_service(mgmtd_server, mgmtd)
    mgmtd_server.start()
    client = nn.NativeRpcClient()
    mcli = svcs.MgmtdRpcClient(mgmtd_server.address, client)
    env = {"pkg": pkg, "client": client, "mcli": mcli, "mgmtd": mgmtd,
           "mgmtd_server": mgmtd_server, "nodes": {}}
    for node_id, tid in node_targets:
        svc = mod(pkg, "storage.craq").StorageService(
            node_id, mcli.refresh_routing, **dev(pkg))
        svc.set_messenger(svcs.RpcMessenger(mcli.refresh_routing, client))
        target = mod(pkg, "storage.target").StorageTarget(
            tid, CHAIN, engine="native", path=str(path / f"t{tid}"),
            chunk_size=CHUNK, **dev(pkg))
        svc.add_target(target)
        server = nn.NativeRpcServer()
        svcs.bind_storage_service(server, svc)
        server.start()
        mgmtd.register_node(node_id, types.NodeType.STORAGE,
                            host=server.host, port=server.port)
        mgmtd.create_target(tid, node_id=node_id)
        env["nodes"][node_id] = {"svc": svc, "server": server,
                                 "target": target}
    mgmtd.upload_chain(CHAIN, [t for _, t in node_targets])
    mgmtd.upload_chain_table(1, [CHAIN])
    for node_id, tid in node_targets:
        mgmtd.heartbeat(node_id, 1,
                        {tid: types.LocalTargetState.UPTODATE})
    return env


def sync_all(env) -> dict:
    """Every node's fast-path registries synced; -> node -> targets."""
    sync = mod(env["pkg"], "storage.native_fastpath").sync_read_fastpath
    return {nid: sync(n["server"], n["svc"])
            for nid, n in env["nodes"].items()}


def storage_client(env, name: str = "fp-test", **kw):
    pkg = env["pkg"]
    return mod(pkg, "client.storage_client").StorageClient(
        name, env["mcli"].refresh_routing,
        mod(pkg, "rpc.services").RpcMessenger(env["mcli"].refresh_routing,
                                              env["client"]),
        **dev(pkg), **kw)


def close(env) -> None:
    env["client"].close()
    for n in env["nodes"].values():
        n["server"].stop()
        n["svc"].stop_workers()
        n["target"].engine.close()
    env["mgmtd_server"].stop()
