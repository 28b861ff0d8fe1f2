"""The port's listeners keep accepting after a client that goes away in
the middle of the connection handshake (``_private/direct.py::
accept_next``): the head's control socket, a process's direct server (a
worker fetching an object from its owner) and the transfer server.  A
SIGKILLed gang rank can leave such a half-open connection; before, the
listener's accept loop returned on it and every later client of that
process hung in its handshake.  No JAX: the JAX package's runtime is not
under test here."""
import socket
import threading

import pytest

T = 30  # seconds: the bound of every connection attempt


def _abandon_handshakes(address, family, n=3):
    for _ in range(n):
        s = socket.socket(family)
        s.connect(address)
        s.close()


def _connects(address, family_name, authkey) -> bool:
    """A real client connects (the handshake completes) within T."""
    from multiprocessing.connection import Client

    out = []

    def run():
        try:
            c = Client(address, family=family_name, authkey=authkey)
            out.append(True)
            c.close()
        except Exception as e:  # noqa: BLE001 - reported below
            out.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(T)
    return out == [True]


@pytest.fixture(scope="module")
def rt():
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=1, num_gpus=0)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_direct_server_survives_abandoned_handshakes(rt):
    from ray_tpu_torch._private.worker import global_worker

    addr = global_worker._direct_server.address["unix"]
    _abandon_handshakes(addr, socket.AF_UNIX)
    assert _connects(addr, "AF_UNIX", rt._head.authkey)


def test_head_survives_abandoned_handshakes(rt):
    head = rt._head
    _abandon_handshakes(head.socket_path, socket.AF_UNIX)
    assert _connects(head.socket_path, "AF_UNIX", head.authkey)
    tcp = (head.tcp_bind_host, head.tcp_port)
    _abandon_handshakes(tcp, socket.AF_INET)
    assert _connects(tcp, "AF_INET", head.authkey)


def test_transfer_server_survives_abandoned_handshakes():
    from ray_tpu_torch._private.transfer import ObjectTransferServer

    authkey = b"k" * 32
    server = ObjectTransferServer(store=None, authkey=authkey,
                                  host="127.0.0.1")
    try:
        addr = ("127.0.0.1", server.port)
        _abandon_handshakes(addr, socket.AF_INET)
        assert _connects(addr, "AF_INET", authkey)
    finally:
        server.shutdown()
