"""The callback relay: k rank processes driven from the caller's process as
if the run happened there.

The reference's services hand one process a mesh of every device and expect
their callbacks (`on_step`, `on_request`, `on_checkpoint`) to fire in that
process at each boundary. torch runs one rank a process, so a k-rank run
starts k processes (`utils/launch.py::start_ranks`, over the `HostEnv` env
contract) and relays every boundary through a key-value store that the
caller's process hosts (a `TCPStore` on localhost):

    ev/<i>           rank 0's i-th event, JSON: ``{"kind": "step" |
                     "request" | "checkpoint" | "done", ...}``
    re/<kind>/<n>    the caller's reply to the event at boundary n, which
                     every rank reads before it takes the next step or
                     request — so all ranks stop, or re-shard, at the
                     boundary an in-process run would

Trees (a state to continue from, a gathered checkpoint, the final state) go
through a temporary directory as one ``.npy`` a leaf; the relay removes the
directory when it closes. Every wait has a timeout: a rank that waits longer
for a reply raises and exits, and the caller, waiting longer for an event,
kills every rank and raises `RankFailure` naming the ones still running. A
rank that exits non-zero ends the run the same way, naming the rank and the
tail of its stderr; no partial record is returned.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from datetime import timedelta

import numpy as np
import torch.distributed as dist

from kubeoperator_tpu_torch.parallel.multislice import HostEnv
from kubeoperator_tpu_torch.utils.launch import (
    free_port_pair,
    start_ranks,
    stop_ranks,
)

RELAY_TIMEOUT_S = 900.0     # the longest wait for one event or one reply
POLL_S = 0.002
ENV_ADDRESS = "KO_TPU_RELAY_ADDRESS"
ENV_DIR = "KO_TPU_RELAY_DIR"
STDERR_TAIL = 3000
EXIT_GRACE_S = 10.0       # a rank gone 0 before rank 0's ``done`` shows


class RankFailure(RuntimeError):
    """A rank exited non-zero, exited before the run ended, or hung."""


def write_tree(directory: str, flat: list[tuple[str, np.ndarray]]) -> None:
    """``[(path, array)]`` as one .npy a leaf plus ``leaves.json``."""
    os.makedirs(directory, exist_ok=True)
    names = []
    for i, (path, arr) in enumerate(flat):
        np.save(os.path.join(directory, f"leaf{i}.npy"), arr, allow_pickle=False)
        names.append([path, f"leaf{i}.npy"])
    with open(os.path.join(directory, "leaves.json"), "w") as f:
        json.dump(names, f)


def read_tree(directory: str) -> dict[str, np.ndarray]:
    """`write_tree`'s leaves as ``{path: array}``."""
    with open(os.path.join(directory, "leaves.json")) as f:
        names = json.load(f)
    return {path: np.load(os.path.join(directory, name), allow_pickle=False)
            for path, name in names}


class Relay:
    """The caller's side of one k-rank run (module docstring). Use it as a
    context manager: leaving it kills what still runs and removes the
    temporary directory."""

    def __init__(self, ranks: int, timeout_s: float = RELAY_TIMEOUT_S) -> None:
        self.ranks = int(ranks)
        self.timeout_s = float(timeout_s)
        self.dir = tempfile.mkdtemp(prefix="ko-relay-")
        self.procs: list = []
        try:
            self.store = dist.TCPStore(
                "127.0.0.1", 0, is_master=True, wait_for_workers=False,
                timeout=timedelta(seconds=self.timeout_s))
        except BaseException:
            shutil.rmtree(self.dir, ignore_errors=True)
            raise

    def __enter__(self) -> "Relay":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        stop_ranks(self.procs)
        shutil.rmtree(self.dir, ignore_errors=True)

    def path(self, name: str) -> str:
        return os.path.join(self.dir, name)

    def start(self, code: str, job: dict) -> None:
        """Write `job` for the ranks to read and start them, each running
        `code` with the env contract's variables and the relay's."""
        with open(self.path("job.json"), "w") as f:
            json.dump(job, f)
        port = free_port_pair()
        envs = [dict(HostEnv(coordinator_address=f"127.0.0.1:{port}",
                             num_processes=self.ranks, process_id=r).to_env(),
                     **{ENV_ADDRESS: f"127.0.0.1:{self.store.port}",
                        ENV_DIR: self.dir})
                for r in range(self.ranks)]
        self.procs = start_ranks(code, envs, self.dir)

    def events(self):
        """Rank 0's events in order, as they arrive; ends after ``done``,
        once every rank has exited 0."""
        i = 0
        while True:
            key = f"ev/{i}"
            deadline = time.monotonic() + self.timeout_s
            early = None
            while not self.store.check([key]):
                codes = self._codes_or_raise()
                if early is None and 0 in codes:
                    # a rank exits 0 only after rank 0 posted ``done``:
                    # allow the store a moment to show it
                    early = time.monotonic()
                if early is not None and time.monotonic() - early > EXIT_GRACE_S:
                    gone = [r for r, rc in enumerate(codes) if rc == 0]
                    self._fail(f"rank(s) {gone} exited before the run "
                               f"ended", gone[0])
                if time.monotonic() > deadline:
                    self._hung(f"no event {i} from rank 0")
                time.sleep(POLL_S)
            event = json.loads(self.store.get(key))
            i += 1
            if event["kind"] == "done":
                self._wait_exit()
            yield event
            if event["kind"] == "done":
                return

    def reply(self, kind: str, n: int, value: dict) -> None:
        self.store.set(f"re/{kind}/{n}", json.dumps(value))

    def _tail(self, rank: int) -> str:
        with open(self.path(f"rank{rank}.err"), errors="replace") as f:
            return f.read()[-STDERR_TAIL:]

    def _fail(self, what: str, rank: int) -> None:
        stop_ranks(self.procs)
        raise RankFailure(f"{what} (of {self.ranks} ranks); rank {rank}'s "
                          f"stderr ends:\n{self._tail(rank)}")

    def _codes_or_raise(self) -> list:
        """Each rank's exit code (None while it runs); raises on the first
        rank found to have exited non-zero."""
        codes = [p.poll() for p in self.procs]
        bad = [r for r, rc in enumerate(codes) if rc not in (None, 0)]
        if bad:
            self._fail("; ".join(f"rank {r} exited with code {codes[r]}"
                                 for r in bad), bad[0])
        return codes

    def _wait_exit(self) -> None:
        deadline = time.monotonic() + self.timeout_s
        while None in self._codes_or_raise():
            if time.monotonic() > deadline:
                self._hung("ranks did not exit after the run ended")
            time.sleep(POLL_S)

    def _hung(self, what: str) -> None:
        running = [r for r, p in enumerate(self.procs) if p.poll() is None]
        self._fail(f"{what} within {self.timeout_s:g} s: rank(s) {running} "
                   f"still running, killed", running[0] if running else 0)


class RankLink:
    """A rank's side of the relay: the job, rank 0's events, the replies."""

    def __init__(self, rank: int) -> None:
        self.rank = int(rank)
        host, port = os.environ[ENV_ADDRESS].rsplit(":", 1)
        self.dir = os.environ[ENV_DIR]
        self.store = dist.TCPStore(host, int(port), is_master=False,
                                   timeout=timedelta(seconds=RELAY_TIMEOUT_S))
        self._next = 0
        with open(os.path.join(self.dir, "job.json")) as f:
            self.job = json.load(f)

    def report(self, event: dict) -> None:
        """Post `event` (rank 0 only; other ranks' calls do nothing)."""
        if self.rank == 0:
            self.store.set(f"ev/{self._next}", json.dumps(event))
            self._next += 1

    def reply(self, kind: str, n: int) -> dict:
        """The caller's reply at boundary n (every rank blocks for it)."""
        return json.loads(self.store.get(f"re/{kind}/{n}"))
