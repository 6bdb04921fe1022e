"""One process per card for a cell that spans cards.

The ranks are started through the port's env contract
(``KO_TPU_COORDINATOR_ADDRESS``, ``KO_TPU_NUM_PROCESSES``,
``KO_TPU_PROCESS_ID``, read by `parallel/multislice.py::initialize_from_env`)
on a free localhost port. Each runs ``python -m <module> <payload>``; rank 0
prints one ``KOBENCH_RANK0 <json>`` line, which is returned. Every rank is
waited for, and any left running is killed, before this returns or raises.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

MARK = "KOBENCH_RANK0 "
PACKAGE_ROOT = str(Path(__file__).resolve().parent.parent)


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(module: str, payload: dict, n: int, timeout_s: float,
              device: str) -> object:
    """Start `n` ranks of `module`, wait for all, return rank 0's object."""
    port = free_port()
    procs = []
    try:
        for rank in range(n):
            env = dict(os.environ,
                       KO_TPU_COORDINATOR_ADDRESS=f"localhost:{port}",
                       KO_TPU_NUM_PROCESSES=str(n), KO_TPU_PROCESS_ID=str(rank),
                       PYTHONPATH=os.pathsep.join(
                           p for p in (PACKAGE_ROOT, os.environ.get("PYTHONPATH"))
                           if p))
            if device == "cpu":
                env["OMP_NUM_THREADS"] = "1"
            procs.append(subprocess.Popen(
                [sys.executable, "-m", module, json.dumps(payload)], env=env,
                stdout=subprocess.PIPE if rank == 0 else subprocess.DEVNULL,
                stdin=subprocess.DEVNULL, text=True))
        out, _ = procs[0].communicate(timeout=timeout_s)
        codes = [procs[0].returncode] + [p.wait(timeout=timeout_s)
                                         for p in procs[1:]]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    if any(codes):
        raise RuntimeError(f"{module}: rank exit codes {codes}")
    lines = [line for line in out.splitlines() if line.startswith(MARK)]
    if not lines:
        raise RuntimeError(f"{module}: rank 0 printed no result")
    return json.loads(lines[-1][len(MARK):])


def report(obj) -> None:
    """Rank 0's side: print `obj` for `run_ranks`."""
    print(MARK + json.dumps(obj), flush=True)
