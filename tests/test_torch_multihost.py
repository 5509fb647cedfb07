"""Multi-process sharded search of the PyTorch port on ``torch.distributed``
(the counterpart of ``tests/test_multihost.py``).

Spawns 2 Python processes, each holding 2 CPU shards, joined by gloo over
TCP on 127.0.0.1: the database is sharded across the process boundary and
the sharded exact search's and sharded tree-x-AH's merges must give every
process the exact results (``tests/torch_multihost_worker.py``). One
process alone runs the same merges through the collectives at a world
size of 1, as the card's host runs NCCL."""

import os
import socket
import subprocess
import sys

import pytest

WORKER = os.path.join(os.path.dirname(__file__), "torch_multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("num_procs", [1, 2])
def test_multiprocess_sharded_search(num_procs, tmp_path):
    port = _free_port()
    env = dict(os.environ)
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(i), str(num_procs), str(port),
             str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True)
        for i in range(num_procs)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"multihost workers timed out; partial output: {outs}")
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert "multihost sharded search OK" in out
        assert "multihost sharded tree-AH OK" in out
        assert "multihost warm-start OK" in out
