"""An in-process kvd replication group on loopback sockets, each member of
either package (``tpu3fs.kv.replica`` or ``tpu3fs_torch.kv.replica``):
the harness of ``tests/test_kv_replica.py``, with every member's package
chosen. Group members restart on the fixed ports of their peer map, so the
ports are reserved below the kernel's ephemeral range
(``reserve_group_port``), and every wait is bounded."""

import importlib
import random
import socket
import time


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def reserve_group_port(exclude=()) -> int:
    """A bindable port below the ephemeral range: an outbound connection's
    source port could otherwise squat on a killed member's freed port and
    block its restart. ``exclude`` lists ports that stay reserved while
    their owner is dead (a dead member's port probes as bindable)."""
    for _ in range(400):
        p = random.randrange(20000, 30000)
        if p in exclude:
            continue
        s = socket.socket()
        try:
            s.bind(("127.0.0.1", p))
            return p
        except OSError:
            continue
        finally:
            s.close()
    raise RuntimeError("no free port in 20000-30000")


class Group:
    """``pkgs`` maps node id -> package name; data under ``tmp_path``."""

    def __init__(self, tmp_path, pkgs, dirs=None, peers=None, **svc_kw):
        self.pkgs = dict(pkgs)
        ports = set()
        if peers is None:
            peers = {}
            for i in self.pkgs:
                peers[i] = ("127.0.0.1", reserve_group_port(exclude=ports))
                ports.add(peers[i][1])
        self.peers = dict(peers)
        self.dirs = dirs or {i: str(tmp_path / f"kvd{i}") for i in self.pkgs}
        self.servers, self.svcs = {}, {}
        self._kw = dict(election_timeout_s=(0.25, 0.5), heartbeat_s=0.05)
        self._kw.update(svc_kw)
        try:
            for i in self.pkgs:
                self.start_node(i)
        except BaseException:
            self.stop()
            raise

    def start_node(self, i, pkg=None):
        pkg = pkg or self.pkgs[i]
        self.pkgs[i] = pkg
        net, replica = mod(pkg, "rpc.net"), mod(pkg, "kv.replica")
        deadline = time.monotonic() + 15.0
        while True:  # a stopped listener may still be draining
            try:
                server = net.RpcServer(port=self.peers[i][1])
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise AssertionError(f"port {self.peers[i][1]} never "
                                         "freed")
                time.sleep(0.1)
        svc = replica.ReplicatedKvService(i, self.peers,
                                          data_dir=self.dirs[i], **self._kw)
        replica.bind_replicated_kv(server, svc)
        server.start()
        self.servers[i], self.svcs[i] = server, svc
        return svc

    def kill_node(self, i):
        """Abrupt: stop serving and halt the Raft ticker."""
        self.svcs[i].stop()
        self.servers[i].stop()
        self.servers[i] = None

    def live(self):
        return [i for i in self.svcs if self.servers.get(i) is not None]

    def wait_leader(self, timeout=15.0, exclude=()):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            leaders = [i for i in self.live() if i not in exclude
                       and self.svcs[i].role == "leader"]
            if len(leaders) == 1:
                return leaders[0]
            time.sleep(0.05)
        raise AssertionError(f"no (single) leader elected in {timeout} s")

    def wait_applied(self, i, index, timeout=15.0):
        deadline = time.monotonic() + timeout
        while self.svcs[i].last_applied < index:
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"member {i} applied {self.svcs[i].last_applied} < "
                    f"{index} after {timeout} s")
            time.sleep(0.05)

    def client(self, pkg="tpu3fs_torch"):
        return mod(pkg, "kv.remote").ReplicatedRemoteKVEngine(self.peers)

    def stop(self):
        for svc in self.svcs.values():
            svc.stop()
        for srv in self.servers.values():
            if srv is not None:
                srv.stop()
        self.servers = {i: None for i in self.servers}
