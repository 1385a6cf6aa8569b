"""The port's template service (``tpu3fs_torch/simple_example/``) against
the JAX package's, on the CPU: the service's replies in process, over
each package's ``RpcServer`` with either package's ``RpcClient``, from
``SimpleExampleApp`` on ``run_background``, and from
``python -m tpu3fs_torch.simple_example.service`` as its own process,
which answers and exits 0 on SIGTERM. The app takes ``device`` like every
app of the port: the card unless the caller asks for another."""

import importlib
import os
import pathlib
import signal
import socket
import subprocess
import sys
import time

import pytest
import torch

from tpu3fs_torch.utils.result import FsError

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGES = ["tpu3fs", "tpu3fs_torch"]
STOP_S = 10.0


def _mods(pkg: str):
    svc = importlib.import_module(f"{pkg}.simple_example.service")
    net = importlib.import_module(f"{pkg}.rpc.net")
    return svc, net


def _calls(svc):
    """One write/read sequence -> the replies, as plain tuples."""
    return [("w", svc.SimpleWriteReq("a", "b"), svc.SimpleWriteRsp),
            ("w", svc.SimpleWriteReq("c", ""), svc.SimpleWriteRsp),
            ("w", svc.SimpleWriteReq("a", "z" * 300), svc.SimpleWriteRsp),
            ("r", svc.SimpleReadReq("a"), svc.SimpleReadRsp),
            ("r", svc.SimpleReadReq("c"), svc.SimpleReadRsp),
            ("r", svc.SimpleReadReq("nope"), svc.SimpleReadRsp)]


def _direct(pkg: str):
    svc, _ = _mods(pkg)
    s = svc.SimpleExampleService()
    return [repr(s.write(req) if op == "w" else s.read(req))
            for op, req, _ in _calls(svc)]


def _over_rpc(client_pkg: str, address):
    svc, net = _mods(client_pkg)
    client = net.RpcClient()
    try:
        return [repr(client.call(address, svc.SIMPLE_EXAMPLE_SERVICE_ID,
                                 1 if op == "w" else 2, req, rsp))
                for op, req, rsp in _calls(svc)]
    finally:
        client.close()


def test_direct_replies_equal():
    want = _direct("tpu3fs")
    assert _direct("tpu3fs_torch") == want
    assert want[0] == "SimpleWriteRsp(stored=1)"


def test_module_surface_equal():
    jsvc, _ = _mods("tpu3fs")
    tsvc, _ = _mods("tpu3fs_torch")
    pkg = importlib.import_module("tpu3fs_torch.simple_example")
    assert tsvc.SIMPLE_EXAMPLE_SERVICE_ID == jsvc.SIMPLE_EXAMPLE_SERVICE_ID
    assert sorted(pkg.__all__) == sorted(importlib.import_module(
        "tpu3fs.simple_example").__all__)
    assert tsvc.SimpleExampleConfig().get("greeting") == \
        jsvc.SimpleExampleConfig().get("greeting")


@pytest.mark.parametrize("server_pkg", PACKAGES)
@pytest.mark.parametrize("client_pkg", PACKAGES)
def test_over_rpc_replies_equal(server_pkg, client_pkg):
    svc, net = _mods(server_pkg)
    server = net.RpcServer()
    sdef = svc.bind_simple_example_service(server, svc.SimpleExampleService())
    server.start()
    try:
        got = _over_rpc(client_pkg, server.address)
    finally:
        server.stop()
    assert sdef.name == "SimpleExample"
    assert got == _direct(client_pkg)


def test_app_in_process_answers_like_the_jax_app():
    replies = {}
    for pkg in PACKAGES:
        svc, _ = _mods(pkg)
        kw = {"device": "cpu"} if pkg == "tpu3fs_torch" else {}
        app = svc.SimpleExampleApp(["--port", "0"], **kw)
        app.run_background()
        try:
            replies[pkg] = _over_rpc(pkg, app.server.address)
        finally:
            app.stop()
            if pkg == "tpu3fs_torch":
                assert app.join()
    assert replies["tpu3fs_torch"] == replies["tpu3fs"]
    assert app.device.type == "cpu" and app.service is not None


def test_app_defaults_to_the_card():
    svc, _ = _mods("tpu3fs_torch")
    assert svc.SimpleExampleApp(["--device", "cpu"]).device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        svc.SimpleExampleApp([])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_as_a_process_answers_and_stops_on_sigterm(tmp_path):
    port = _free_port()
    log = tmp_path / "simple_example.log"
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "tpu3fs_torch.simple_example.service",
             "--port", str(port), "--device", "cpu"], cwd=ROOT,
            stdout=out, stderr=subprocess.STDOUT,
            env={**os.environ, "PYTHONPATH": str(ROOT)})
    try:
        deadline = time.monotonic() + 60.0
        while True:
            try:
                got = _over_rpc("tpu3fs_torch", ("127.0.0.1", port))
                break
            except (FsError, ConnectionError, OSError):
                assert proc.poll() is None, log.read_text()
                assert time.monotonic() < deadline, "no answer in 60 s"
                time.sleep(0.1)
        assert got == _direct("tpu3fs")
        # the JAX package's client on the same process: its keys are there
        assert _over_rpc("tpu3fs", ("127.0.0.1", port)) == [
            "SimpleWriteRsp(stored=2)"] * 3 + [
            f"SimpleReadRsp(found=True, value='{'z' * 300}')",
            "SimpleReadRsp(found=True, value='')",
            "SimpleReadRsp(found=False, value='')"]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=STOP_S) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(STOP_S)
    assert "Traceback" not in log.read_text()
