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


def _rank_env(extra: dict[str, str | None]) -> dict[str, str]:
    """This process's environment with `extra` applied (a None value
    removes its variable) and the repo on PYTHONPATH."""
    env = dict(os.environ)
    for key, value in extra.items():
        if value is None:
            env.pop(key, None)
        else:
            env[key] = value
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def start_ranks(code: str, envs: list[dict[str, str | None]], log_dir: str
                ) -> list[subprocess.Popen]:
    """Start `python -c code` once per env block (as `run_ranks` does) and
    return at once; rank r's stdout and stderr go to ``rank<r>.out`` and
    ``rank<r>.err`` in `log_dir`, so a rank never blocks on a full pipe
    while the caller is busy. The caller owns the processes: it waits for
    them and kills what is left (`stop_ranks`)."""
    procs = []
    try:
        for rank, extra in enumerate(envs):
            with open(os.path.join(log_dir, f"rank{rank}.out"), "w") as out, \
                    open(os.path.join(log_dir, f"rank{rank}.err"), "w") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", code], env=_rank_env(extra),
                    cwd=REPO_ROOT, stdout=out, stderr=err,
                    stdin=subprocess.DEVNULL))
    except BaseException:
        stop_ranks(procs)
        raise
    return procs


def stop_ranks(procs: list[subprocess.Popen]) -> None:
    """Kill every process still running and reap them all."""
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
    for proc in procs:
        proc.wait()


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
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code], env=_rank_env(extra),
                cwd=REPO_ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        results = []
        for proc in procs:
            out, err = proc.communicate(timeout=timeout_s)
            results.append((proc.returncode, out, err))
        return results
    finally:
        stop_ranks(procs)
