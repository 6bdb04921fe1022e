"""The device half of the reference's chaos soaks: the preemption, queue and
serving drills of `kubeoperator_tpu/cli/koctl.py` replayed as their scripts
of device calls through the port's seams (`service/workload.py`) and the
port's checkpoints.

    python -m kubeoperator_tpu_torch.cli.koctl chaos-soak --preemption|--queue|
        --serve [--mesh data=2,fsdp=4]
        [--config default|bench-f32] [--seed N] [--verify-determinism]
        [--format json] [--work-dir DIR] [--cpu]

The reference soaks prove survival from journal rows, the slice ledger, the
event bus and one stitched span tree; that is control-plane code, which the
port does not carry. What the port carries is the device fact each survival
claim ends in, and a drill checks exactly those, in the reference's words
where a check is wholly a device fact:

=================  =========================================================
reference soak     device calls replayed here
=================  =========================================================
`_preemption_      loss scenario: the slice pool's degrade leg
soak_once`         (`resilience/slicepool.py::_reshard`) trains
                   `RESHARD_STEPS` from scratch on the survivor mesh; a
                   fresh run there must equal it
`_notice_soak_     notice scenario: `NOTICE_STEPS` on the full mesh drained
once`              at `NOTICE_AT` into a checkpoint; the degrade leg resumes
                   it on the survivor mesh for `RESHARD_STEPS`; `train
                   --resume` finishes it on the full mesh; drained plus
                   resumed losses must equal the uninterrupted run
`_queue_soak_      alice (`QUEUE_STEPS`, one slice's gang) drained at
once`              `PREEMPT_AT`; carol, then bob (`SHORT_STEPS` each, the
                   soak's dispatch order); alice resumes, equal to her
                   uninterrupted run
`_serve_soak_      sierra trains `SIERRA_STEPS` on the full mesh into a
once`              checkpoint; the server restores it and answers
                   `SERVE_REQUESTS`, re-sharding onto the survivor after
                   request `RESHARD_AT` (digests before it equal an
                   undegraded serve bit for bit, after it within the soak's
                   band); tina (`TINA_STEPS`, one slice) drained at
                   `DRAIN_AT` and resumed equals her uninterrupted run;
                   uma runs `SHORT_STEPS`
=================  =========================================================

The port has no queue, so the serving drill runs the server and tina one
after the other, where the reference's two dispatch lanes run them at once.

Meshes: `mesh` is the full mesh (default the soaks' data=2,fsdp=4); the
survivor mesh is `parallel/multislice.py::degraded_mesh_spec` of it over
`SOAK_SLICES` slices, one lost, as the slice pool plans it. A one-device
mesh loses no slice and keeps a device: its survivor mesh is the full mesh,
``shrunk_axis`` is None, and the drill does not degrade (the serving drill
issues no reshard). One-slice gangs (the queue's, tina's, uma's) run on the
survivor mesh.

Every run is seeded from `seed` (the reference's runs use 0, the tenants'
seed and the slice pool's `reshard_seed`). A mesh larger than the visible
devices is refused before any run (`service/workload.py::ranks_for`); a
rank that fails raises `RankFailure` naming it. Each drill returns
``(checks, structure)`` as the reference's do (checks: ``{"check", "ok",
"detail"}``; structure: what `--verify-determinism` compares between two
passes), and appends each run's wall-clock windows to `windows`, the
checkpoints' with their bytes and the serving runs' with their latencies.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

from kubeoperator_tpu_torch.parallel.mesh import MeshSpec
from kubeoperator_tpu_torch.parallel.multislice import degraded_mesh_spec
from kubeoperator_tpu_torch.parallel.validation_net import NetConfig
from kubeoperator_tpu_torch.service import workload as sw
from kubeoperator_tpu_torch.workloads.checkpoint import (
    MANIFEST_NAME,
    restore_checkpoint,
    save_checkpoint,
)
from kubeoperator_tpu_torch.workloads.partition import tree_paths
from kubeoperator_tpu_torch.workloads.step import train_state_shapes

DEFAULT_MESH = "data=2,fsdp=4,tp=1"   # the soaks' 2 x v5e-4 cluster
SOAK_SLICES = 2
RESHARD_STEPS = 4      # the slice pool's reshard_steps
NOTICE_STEPS, NOTICE_AT = 6, 2
QUEUE_STEPS, PREEMPT_AT, SHORT_STEPS = 6, 2, 3
SIERRA_STEPS, SERVE_REQUESTS, RESHARD_AT = 4, 6, 2
TINA_STEPS, DRAIN_AT = 6, 2
SERVE_BAND_RTOL = 0.25  # the serve soak's band for digests after a reshard


@dataclasses.dataclass(frozen=True)
class Layout:
    """The full mesh, the survivor mesh and the axis that shrank (None on
    a one-device mesh, where the survivor mesh is the full mesh)."""

    full: MeshSpec
    survivor: MeshSpec
    shrunk_axis: str | None

    @property
    def where(self) -> str:
        """How a check names the survivor mesh."""
        if self.shrunk_axis:
            return "the degraded mesh"
        return "the survivor mesh (the full mesh: one device loses no slice)"


def plan(mesh: str | MeshSpec) -> Layout:
    full = mesh if isinstance(mesh, MeshSpec) else sw.workload_spec(mesh, 0)
    if full.total_devices == 1:
        return Layout(full, full, None)
    survivor, axis = degraded_mesh_spec(full, SOAK_SLICES)
    return Layout(full, survivor, axis)


class _Drill:
    """One drill's runs, checks and windows."""

    def __init__(self, mesh, cfg, seed, device, visible, work_dir, windows):
        self.layout = plan(mesh or DEFAULT_MESH)
        self.cfg = cfg or NetConfig()
        self.seed = int(seed)
        self.device, self.visible = device, visible
        self.work_dir = work_dir
        self.windows = windows if windows is not None else []
        self.checks: list[dict] = []
        # refused before any run, as the seams refuse
        sw.ranks_for(self.layout.full, device, visible)

    def check(self, name: str, ok, detail: str = "") -> None:
        self.checks.append({"check": name, "ok": bool(ok), "detail": detail})

    def _keep(self, what: str, windows: list, **attrs) -> None:
        for w in windows:
            self.windows.append(dict(w, attrs={**w.get("attrs", {}),
                                               "run": what, **attrs}))

    def train(self, what: str, spec: MeshSpec, steps: int, state=None,
              seed: int | None = None, stop_at: int | None = None,
              keep_state: bool = False) -> dict:
        run = sw.run_training(
            spec, cfg=self.cfg, steps=steps, mode="auto",
            seed=self.seed if seed is None else seed, state=state,
            on_step=(lambda completed, _loss: completed >= stop_at)
            if stop_at else None,
            return_state=keep_state, device=self.device, visible=self.visible)
        self._keep(what, run.pop("windows"))
        return run

    def serve(self, what: str, spec: MeshSpec, params, seed: int,
              on_request=None) -> dict:
        run = sw.run_serving(
            spec, self.cfg, params=params, requests=SERVE_REQUESTS,
            mode="auto", seed=seed, on_request=on_request, device=self.device,
            visible=self.visible)
        self._keep(what, run.pop("windows"),
                   latency_p50_ms=run["latency_p50_ms"],
                   latency_p95_ms=run["latency_p95_ms"])
        return run

    def save(self, what: str, tenant: str, run: dict, target_steps: int
             ) -> dict:
        t0 = time.time()
        manifest = save_checkpoint(
            os.path.join(self.work_dir, tenant), run.pop("state"),
            step=run["end_step"], target_steps=target_steps, mesh=run["mesh"],
            losses=run["losses"], seed=self.seed)
        self._keep(what, [{"name": "checkpoint-save", "start": t0,
                           "end": time.time(),
                           "attrs": {"bytes": manifest["total_bytes"]}}])
        return manifest

    def restore(self, what: str, manifest: dict) -> tuple[dict, dict]:
        t0 = time.time()
        state, back = restore_checkpoint(manifest["dir"],
                                         train_state_shapes(self.cfg))
        self._keep(what, [{"name": "checkpoint-restore", "start": t0,
                           "end": time.time(),
                           "attrs": {"bytes": back["total_bytes"]}}])
        return state, back


def _loss_scenario(d: _Drill) -> dict:
    full, survivor, axis = d.layout.full, d.layout.survivor, d.layout.shrunk_axis
    if axis:
        was, now = full.describe()[axis], survivor.describe()[axis]
        d.check(f"degraded-mesh plan shrank the {axis} axis ({axis}={was} -> "
                f"{now})", survivor.total_devices < full.total_devices,
                str(survivor))
    # the degrade leg: no tenant checkpoint, so from scratch
    reshard = d.train("loss/reshard", survivor, RESHARD_STEPS)
    n = survivor.total_devices
    d.check(f"workload continued on {d.layout.where} "
            f"({n} device{'s' if n > 1 else ''})",
            reshard["ok"] and reshard["devices"] == n,
            str({k: reshard[k] for k in ("ok", "devices", "losses")}))
    fresh = d.train("loss/fresh", survivor, RESHARD_STEPS)
    d.check("loss parity pinned vs a from-scratch degraded run",
            fresh["losses"] == reshard["losses"],
            f"{fresh['losses']} vs {reshard['losses']}")
    return {"full_mesh": str(full), "degraded_mesh": str(survivor),
            "shrunk_axis": axis, "losses": reshard["losses"]}


def _notice_scenario(d: _Drill) -> dict:
    full, survivor = d.layout.full, d.layout.survivor
    reference = d.train("notice/reference", full, NOTICE_STEPS)
    drained = d.train("notice/drained", full, NOTICE_STEPS, stop_at=NOTICE_AT,
                      keep_state=True)
    ckpt = d.save("notice/drained", "notice", drained, NOTICE_STEPS)
    d.check("workload drained at the notice step with a real checkpoint",
            drained["stopped_early"] and drained["finite"]
            and drained["end_step"] == NOTICE_AT and ckpt["step"] == NOTICE_AT
            and ckpt["target_steps"] == NOTICE_STEPS,
            f"end_step={drained['end_step']} checkpoint step={ckpt['step']}")
    d.check("checkpoint carries the full TrainState on disk",
            os.path.isfile(os.path.join(ckpt["dir"], MANIFEST_NAME))
            and [leaf["path"] for leaf in ckpt["leaves"]]
            == [path for path, _ in tree_paths(train_state_shapes(d.cfg))],
            ckpt["dir"])
    state, back = d.restore("notice/degrade", ckpt)
    reshard = d.train("notice/degrade", survivor, RESHARD_STEPS, state=state,
                      seed=back["seed"])
    d.check(f"degrade leg RESUMED the checkpoint on {d.layout.where}",
            reshard["ok"] and reshard["start_step"] == NOTICE_AT
            and reshard["devices"] == survivor.total_devices,
            str({k: reshard[k] for k in ("ok", "start_step", "devices")}))
    state, back = d.restore("notice/resume", ckpt)
    resumed = d.train("notice/resume", full, NOTICE_STEPS - NOTICE_AT,
                      state=state, seed=back["seed"])
    d.check("resume restored real step/optimizer state",
            resumed["start_step"] == NOTICE_AT
            and resumed["end_step"] == NOTICE_STEPS,
            f"{resumed['start_step']}->{resumed['end_step']}")
    stitched = drained["losses"] + resumed["losses"]
    d.check("loss parity: drained+resumed == uninterrupted, bit-for-bit",
            stitched == reference["losses"] and len(stitched) == NOTICE_STEPS,
            f"{stitched} vs {reference['losses']}")
    return {"losses": stitched, "reference": reference["losses"],
            "checkpoint_step": ckpt["step"],
            "checkpoint_bytes": ckpt["total_bytes"],
            "degraded_mesh": str(survivor), "degraded_losses": reshard["losses"]}


PREEMPTION_SCENARIOS = {"loss": _loss_scenario, "notice": _notice_scenario}


def preemption_drill(mesh=DEFAULT_MESH, cfg: NetConfig | None = None,
                     seed: int = 0, *, device=None, visible=None,
                     work_dir: str, windows: list | None = None
                     ) -> tuple[list, dict]:
    """`_preemption_soak_once` and `_notice_soak_once`, merged as
    `cmd_preemption_soak` merges them: checks prefixed ``[loss]`` and
    ``[notice]``, structure ``{"loss", "notice"}``."""
    checks, structure = [], {}
    for name, scenario in PREEMPTION_SCENARIOS.items():
        d = _Drill(mesh, cfg, seed, device, visible,
                   os.path.join(work_dir, name), windows)
        structure[name] = scenario(d)
        checks += [dict(c, check=f"[{name}] {c['check']}") for c in d.checks]
    return checks, structure


def queue_drill(mesh=DEFAULT_MESH, cfg: NetConfig | None = None,
                seed: int = 0, *, device=None, visible=None, work_dir: str,
                windows: list | None = None) -> tuple[list, dict]:
    """`_queue_soak_once`'s device calls: one slice's gang each."""
    d = _Drill(mesh, cfg, seed, device, visible, work_dir, windows)
    gang = d.layout.survivor
    reference = d.train("queue/reference", gang, QUEUE_STEPS)
    alice = d.train("queue/alice", gang, QUEUE_STEPS, stop_at=PREEMPT_AT,
                    keep_state=True)
    ckpt = d.save("queue/alice", "alice", alice, QUEUE_STEPS)
    carol = d.train("queue/carol", gang, SHORT_STEPS)
    bob = d.train("queue/bob", gang, SHORT_STEPS)
    state, back = d.restore("queue/alice-resumed", ckpt)
    resumed = d.train("queue/alice-resumed", gang, QUEUE_STEPS - PREEMPT_AT,
                      state=state, seed=back["seed"])
    runs = [("alice", alice), ("carol", carol), ("bob", bob),
            ("alice", resumed)]
    d.check("all three tenants' runs finished: alice drained finite and "
            "resumed ok, carol and bob ok",
            alice["finite"] and resumed["ok"] and carol["ok"] and bob["ok"],
            str({t: r["ok"] for t, r in runs}))
    d.check(f"alice drained at the step-{PREEMPT_AT} boundary with a "
            f"checkpoint",
            alice["stopped_early"] and alice["end_step"] == PREEMPT_AT
            and ckpt["step"] == PREEMPT_AT, str(ckpt["step"]))
    order = [(tenant, r["start_step"]) for tenant, r in runs]
    d.check("run order: alice -> carol (preemptor) -> bob -> alice resumed "
            f"from step {PREEMPT_AT}",
            order == [("alice", 0), ("carol", 0), ("bob", 0),
                      ("alice", PREEMPT_AT)], str(order))
    d.check("alice's checkpoints live in her namespace (<dir>/alice/...)",
            os.sep + "alice" + os.sep in ckpt["dir"] + os.sep, ckpt["dir"])
    losses = alice["losses"] + resumed["losses"]
    d.check("alice's drained+resumed losses == uninterrupted run, "
            "bit-for-bit",
            losses == reference["losses"] and len(losses) == QUEUE_STEPS,
            f"{losses} vs {reference['losses']}")
    return d.checks, {"gang_mesh": str(gang), "order": order,
                      "ledger": [("drained", alice["end_step"])],
                      "losses": losses, "reference": reference["losses"]}


def serve_drill(mesh=DEFAULT_MESH, cfg: NetConfig | None = None,
                seed: int = 0, *, device=None, visible=None, work_dir: str,
                windows: list | None = None) -> tuple[list, dict]:
    """`_serve_soak_once`'s device calls, the server and tina in turn."""
    d = _Drill(mesh, cfg, seed, device, visible, work_dir, windows)
    full, survivor, axis = d.layout.full, d.layout.survivor, d.layout.shrunk_axis
    sierra = d.train("serve/sierra", full, SIERRA_STEPS, keep_state=True)
    ckpt = d.save("serve/sierra", "sierra", sierra, SIERRA_STEPS)
    d.check("pre-training left sierra a COMPLETE checkpoint recording the "
            "serve gang's mesh",
            ckpt["mesh"] == full.describe() and ckpt["step"] == SIERRA_STEPS,
            str(ckpt["mesh"]))
    state, back = d.restore("serve/restore", ckpt)
    reference = d.serve("serve/reference", full, state["params"], back["seed"])

    def lose_a_slice(served, _latency_s):
        return ("reshard", survivor) if axis and served == RESHARD_AT else None

    server = d.serve("serve/server", full, state["params"], back["seed"],
                     on_request=lose_a_slice)
    d.check(("the degraded server answered EVERY request on the smaller mesh"
             if axis else "the server answered EVERY request on "
             + d.layout.where),
            server["served"] == SERVE_REQUESTS and server["degraded"] == bool(axis)
            and not server["drained"] and server["finite"]
            and server["devices"] == survivor.total_devices,
            str({k: server[k] for k in ("served", "degraded", "drained",
                                        "finite", "devices")}))
    outputs, want = server["outputs"], reference["outputs"]
    pre = outputs[:RESHARD_AT] == want[:RESHARD_AT]
    post = (len(outputs) == SERVE_REQUESTS and bool(np.isfinite(outputs).all())
            and bool(np.allclose(outputs, want, rtol=SERVE_BAND_RTOL)))
    d.check("response digests: bit-for-bit vs the undegraded reference "
            "before the reshard, finite and in-band after it", pre and post,
            f"{outputs} vs {want}")
    tina_ref = d.train("serve/tina-reference", survivor, TINA_STEPS)
    tina = d.train("serve/tina", survivor, TINA_STEPS, stop_at=DRAIN_AT,
                   keep_state=True)
    tina_ckpt = d.save("serve/tina", "tina", tina, TINA_STEPS)
    d.check(f"tina drained at her step-{DRAIN_AT} boundary with a checkpoint",
            tina["stopped_early"] and tina["end_step"] == DRAIN_AT
            and tina_ckpt["step"] == DRAIN_AT, str(tina_ckpt["step"]))
    state, back = d.restore("serve/tina-resumed", tina_ckpt)
    resumed = d.train("serve/tina-resumed", survivor, TINA_STEPS - DRAIN_AT,
                      state=state, seed=back["seed"])
    losses = tina["losses"] + resumed["losses"]
    d.check("tina ran twice; drained+resumed losses == uninterrupted run, "
            "bit-for-bit",
            losses == tina_ref["losses"] and len(losses) == TINA_STEPS,
            f"{losses} vs {tina_ref['losses']}")
    uma = d.train("serve/uma", survivor, SHORT_STEPS)
    d.check("post-chaos probe: uma's run finished ok on one slice's gang",
            uma["ok"], str(uma["losses"]))
    return d.checks, {"served": server["served"], "degraded_mesh": server["mesh"],
                      "shrunk_axis": axis, "outputs": outputs,
                      "reference_outputs": want, "losses": losses,
                      "reference": tina_ref["losses"],
                      "uma_losses": uma["losses"]}


DRILLS = {"preemption": preemption_drill, "queue": queue_drill,
          "serve": serve_drill}
