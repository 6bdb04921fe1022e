"""One OS process per rank of the host env contract, on this host.

The reference runs its multi-process smokes (`ops/dcn_smoke.py`) and its
multi-device dry run in one process that sees every device; torch puts
one rank in each process, so the port starts them: each process gets
the KO_TPU_* variables of its rank (`parallel/multislice.py::HostEnv`)
and joins the process group through `initialize_from_env`. The port's
multi-rank tests and `chip_smoke.py` start their ranks here too.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port_pair() -> int:
    """A free port whose successor is free too: the multislice env contract
    hands out port for the rendezvous and port+1 for the megascale
    coordinator (65535, which has no successor, is never returned)."""
    for _attempt in range(32):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
            if port >= 65535:
                continue
            with socket.socket() as s2:
                try:
                    s2.bind(("127.0.0.1", port + 1))
                except OSError:
                    continue
                return port
    raise RuntimeError("no free adjacent port pair found for the "
                       "multislice coordinator contract")


def run_ranks(code: str, envs: list[dict[str, str | None]], timeout_s: float
              ) -> list[tuple[int, str, str]]:
    """Run `python -c code` once per env block (added to this process's
    environment, a None value removing its variable, with the repo on
    PYTHONPATH), all at once; returns each process's (exit code, stdout,
    stderr) in the order of `envs`. A process still running after
    `timeout_s` raises `subprocess.TimeoutExpired`; every process is gone
    when this returns or raises."""
    procs = []
    try:
        for extra in envs:
            env = dict(os.environ)
            for key, value in extra.items():
                if value is None:
                    env.pop(key, None)
                else:
                    env[key] = value
            env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code], env=env, cwd=REPO_ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        results = []
        for proc in procs:
            out, err = proc.communicate(timeout=timeout_s)
            results.append((proc.returncode, out, err))
        return results
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
