"""The port's runtime CLI as two processes over gloo on the CPU: a global
dp mesh of 4 positions, 2 a process, as the JAX package's multi-process
test lays out its devices (``test_distributed_multiprocess.py``).  The
workers are the port's own entry point, each told its rank by the
environment, as ``torchrun`` would tell it."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from tfhe_fbs_map_tpu.frontend import HeuristicMapper
from tfhe_fbs_map_tpu.frontend.circuits import build_bench
from tfhe_fbs_map_tpu_torch.parallel.distributed import shutdown
from tfhe_fbs_map_tpu_torch.runtime.cli import main

ROOT = Path(__file__).resolve().parents[1]
# per worker: python, torch and the gloo rendezvous, then a tiny run
WORKER_TIMEOUT = 50
# rendezvous attempts, each on a fresh port, and how a taken port shows
RENDEZVOUS_TRIES = 3
IN_USE = "EADDRINUSE"
# the fields of the JSON line that are not wall times
TIMES = {"encrypt_s", "run_s", "boots_per_sec"}

torch.set_num_threads(1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def full_adder_lbf(tmp_path_factory):
    prog = HeuristicMapper(cone_merger="search", fbs_size=4) \
        .map(build_bench("full_adder"))
    prog.remove_dangling_nodes()
    path = tmp_path_factory.mktemp("lbf") / "fa.lbf"
    with open(path, "w") as f:
        prog.write_lbf(f)
    return str(path)


def run_ranks(argv: list[str], world: int = 2) -> list[tuple]:
    """``python -m tfhe_fbs_map_tpu_torch.runtime argv`` as ``world``
    processes of one group; (exit code, stdout, stderr) of each.  The port
    is free when it is picked but may be taken before rank 0 binds it (the
    other test workers open sockets too); then rank 0 fails at once, the
    others are stopped, and the group is started again on a fresh
    port."""
    for _ in range(RENDEZVOUS_TRIES):
        ranks = _run_ranks(argv, world, _free_port())
        if not any(IN_USE in err for _, _, err in ranks):
            break
    return ranks


def _run_ranks(argv: list[str], world: int, port: int) -> list[tuple]:
    procs = []
    try:
        for rank in range(world):
            env = {**os.environ, "MASTER_ADDR": "127.0.0.1",
                   "MASTER_PORT": str(port), "WORLD_SIZE": str(world),
                   "RANK": str(rank), "OMP_NUM_THREADS": "1",
                   "GLOO_SOCKET_IFNAME": "lo"}
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "tfhe_fbs_map_tpu_torch.runtime",
                 *argv], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        outs = [procs[0].communicate(timeout=WORKER_TIMEOUT)]
        if IN_USE in outs[0][1]:
            # rank 0 could not bind the port; the others wait for it
            return [(procs[0].returncode, *outs[0])]
        outs += [p.communicate(timeout=WORKER_TIMEOUT) for p in procs[1:]]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, out, err) for p, (out, err) in zip(procs, outs)]


def test_two_process_mesh_run(full_adder_lbf, capsys):
    argv = [full_adder_lbf, "--test-params", "--device", "cpu", "--mesh",
            "4", "--batch", "8"]
    (rc0, out0, err0), (rc1, out1, err1) = run_ranks(argv)
    assert rc0 == 0, err0
    assert rc1 == 0, err1
    # rank 0 alone prints the JSON line, of the whole gathered batch
    assert out1 == ""
    res = json.loads(out0.strip().splitlines()[-1])
    assert res["bit_exact"] and res["wrong_bits"] == 0
    assert res["mesh"] == {"dp": 4, "tp": 1} and res["batch"] == 8
    assert "# mesh: dp=4 tp=1" in err0 and "# mesh: dp=4 tp=1" in err1
    # the same run in one process with four positions
    assert main(argv) == 0
    one = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {k: v for k, v in res.items() if k not in TIMES} \
        == {k: v for k, v in one.items() if k not in TIMES}


def test_two_process_mesh_refuses_a_checkpoint(full_adder_lbf, tmp_path):
    ckpt = str(tmp_path / "c.npz")
    for rc, out, err in run_ranks([full_adder_lbf, "--test-params",
                                   "--device", "cpu", "--mesh", "auto",
                                   "--checkpoint", ckpt]):
        assert rc == 2 and out == "" and "spans processes" in err


def test_cli_keeps_a_group_its_caller_holds(full_adder_lbf, capsys):
    """The CLI leaves a process group it joined itself (a rank that exits
    with its gloo group alive can abort in the group's destructor, which
    made ``test_two_process_mesh_run`` fail now and then), and keeps one
    its caller holds."""
    dist.init_process_group("gloo", world_size=1, rank=0,
                            init_method=f"tcp://127.0.0.1:{_free_port()}")
    try:
        assert main([full_adder_lbf, "--test-params", "--device", "cpu",
                     "--batch", "2"]) == 0
        assert dist.is_initialized()
    finally:
        shutdown()
    assert not dist.is_initialized()
