"""simple_example: the template service for adding new services.

Mirrors the reference's src/simple_example/ — a minimal service built on the
app framework (src/simple_example/main.cpp, src/fbs/simple_example/
SerdeService.h:16): one RPC service with an echo-style method plus the
embedded core service, demonstrating the full binary lifecycle (config,
server setup, service binding, signal-driven shutdown). Copy this module to
start a new service.

The port's own copy of ``tpu3fs/simple_example/service.py``: the same
methods and wire types. Like every app of the port, ``SimpleExampleApp``
takes ``device`` (keyword, else ``--device``), which resolves to the card
and raises at construction when none is present and none was asked for.
Run it as its own process with
``python -m tpu3fs_torch.simple_example.service --port P [--device cpu]``;
SIGTERM stops it with exit code 0.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import List, Optional

from tpu3fs_torch.app.application import OnePhaseApplication
from tpu3fs_torch.mgmtd.types import NodeType
from tpu3fs_torch.rpc.net import RpcServer, ServiceDef
from tpu3fs_torch.utils.config import Config, ConfigItem

SIMPLE_EXAMPLE_SERVICE_ID = 1000  # ref src/fbs/simple_example/SerdeService.h


@dataclass
class SimpleWriteReq:
    key: str = ""
    value: str = ""


@dataclass
class SimpleWriteRsp:
    stored: int = 0


@dataclass
class SimpleReadReq:
    key: str = ""


@dataclass
class SimpleReadRsp:
    found: bool = False
    value: str = ""


class SimpleExampleService:
    """A tiny KV kept in memory — the 'sample write RPC' of the reference."""

    def __init__(self):
        self._data = {}

    def write(self, req: SimpleWriteReq) -> SimpleWriteRsp:
        self._data[req.key] = req.value
        return SimpleWriteRsp(stored=len(self._data))

    def read(self, req: SimpleReadReq) -> SimpleReadRsp:
        if req.key in self._data:
            return SimpleReadRsp(True, self._data[req.key])
        return SimpleReadRsp(False, "")


def bind_simple_example_service(
    server: RpcServer, svc: SimpleExampleService
) -> ServiceDef:
    s = ServiceDef(SIMPLE_EXAMPLE_SERVICE_ID, "SimpleExample")
    s.method(1, "write", SimpleWriteReq, SimpleWriteRsp, svc.write)
    s.method(2, "read", SimpleReadReq, SimpleReadRsp, svc.read)
    server.add_service(s)
    return s


class SimpleExampleConfig(Config):
    greeting = ConfigItem("hello", hot=True)


class SimpleExampleApp(OnePhaseApplication):
    node_type = NodeType.CLIENT

    def __init__(self, argv: Optional[List[str]] = None, *, device=None):
        super().__init__(argv, device=device)
        self.service: Optional[SimpleExampleService] = None

    def default_config(self) -> Config:
        return SimpleExampleConfig()

    def build_services(self, server: RpcServer) -> None:
        self.service = SimpleExampleService()
        bind_simple_example_service(server, self.service)


def main(argv: Optional[List[str]] = None) -> int:
    SimpleExampleApp(argv if argv is not None else sys.argv[1:]).run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
