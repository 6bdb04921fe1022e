"""The reference's control-plane services driving the port through its
device seams (`kubeoperator_tpu_torch/service/workload.py`), on the host.

The services import their device functions inside their bodies, so the
tests set those module attributes (`harness.run_training`, `.run_sweep`,
`serve.run_serving`, `checkpoint.restore_checkpoint`) to the port's seams
with ``device="cpu"``, and ``jax.devices`` to the first k virtual devices,
k the port's visible count (`use_port`). The same service calls run once
pure-JAX and once through the port: train, a `step_hook` drain and a
resume, serve from that checkpoint with a reshard directive, the sweep, a
queue preemption drill at world 1, the slice pool's re-shard, and a 2-rank
train through the callback relay (drain, periodic checkpoints, a resume
from a worker thread). Then the seams' refusals and their duck typing.

Tolerances, as `tests/test_torch_workloads.py` and `tests/test_torch_serve.py`
state them: losses and serving digests within 1e-5 relative of JAX's (the
same f32 arithmetic in other summation orders). Within the port a drained
run plus its resume equals the uninterrupted run exactly, as the reference
requires of itself (`tests/test_queue.py`).
"""

import functools
import os
import re
import threading

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from kubeoperator_tpu.models import OperationStatus
from kubeoperator_tpu.parallel import validation_net as jv
from kubeoperator_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from kubeoperator_tpu.utils.errors import KoError
from kubeoperator_tpu.workloads import checkpoint as jck
from kubeoperator_tpu.workloads import harness as jh
from kubeoperator_tpu.workloads import partition as jpart
from kubeoperator_tpu.workloads import serve as jserve
from kubeoperator_tpu.workloads import step as js
from kubeoperator_tpu_torch.parallel import validation_net as pv
from kubeoperator_tpu_torch.parallel.mesh import MeshSpec
from kubeoperator_tpu_torch.service import relay as rl
from kubeoperator_tpu_torch.service import workload as sw
from kubeoperator_tpu_torch.utils.errors import TopologyError, ValidationError
from kubeoperator_tpu_torch.workloads import checkpoint as pck
from kubeoperator_tpu_torch.workloads import partition as ppart

from tests.test_queue import queue_stack
from tests.test_torch_ops import one_spawn_at_a_time
from tests.test_workloads import workload_stack

LOSS_RTOL = 1e-5
DIGEST_RTOL = 1e-5
WORLD_ONE = "data=1,fsdp=1,tp=1"
# the reference's own harness, kept before any test replaces the attribute
JAX_RUN_TRAINING = jh.run_training


def use_devices(mp, k: int) -> None:
    real = jax.devices()
    mp.setattr(jax, "devices", lambda *a, **kw: real[:k])


def use_port(mp, k: int, **train_kw) -> None:
    """The port's seams in the services' place, with k ranks visible."""
    use_devices(mp, k)
    visible = sw.visible_devices("cpu", k)
    mp.setattr(jh, "run_training", functools.partial(
        sw.run_training, device="cpu", visible=visible, **train_kw))
    mp.setattr(jh, "run_sweep", functools.partial(
        sw.run_sweep, devices=visible, device="cpu"))
    mp.setattr(jserve, "run_serving", functools.partial(
        sw.run_serving, device="cpu", visible=visible))
    mp.setattr(jck, "restore_checkpoint", pck.restore_checkpoint)
    # the slice pool's degrade leg catches the error it imports from the
    # reference's module at call time: the port's, once the port restores
    mp.setattr(jck, "CheckpointError", pck.CheckpointError)


def jax_losses(spec: str, steps: int) -> list[float]:
    n = JaxMeshSpec.parse(spec).total_devices
    return JAX_RUN_TRAINING(JaxMeshSpec.parse(spec).build(jax.devices()[:n]),
                            steps=steps)["losses"]


def span_names(svc, op_id: str) -> list[str]:
    return sorted(s.name for s in svc.journal.spans_of(op_id))


def drain_at(svc, step: int):
    def hook(completed, _loss):
        if completed == step:
            svc.workloads.request_drain("drill")
    return hook


def _chain(tmp_path, port: bool) -> dict:
    """train; a drain at step 2 and a resume; serve with a reshard at the
    second request; the sweep — one service stack, world 1."""
    with pytest.MonkeyPatch.context() as mp:
        (use_port if port else use_devices)(mp, 1)
        svc = workload_stack(tmp_path)
        try:
            wl = svc.workloads
            out = {"train": wl.train(mesh="data=1", steps=4)}
            wl.step_hook = drain_at(svc, 2)
            out["drained"] = wl.train(mesh="data=1", steps=4)
            wl.step_hook = None
            out["resumed"] = wl.train(resume=True)
            target = JaxMeshSpec.parse(WORLD_ONE)
            wl.request_hook = lambda served, _l: ("reshard", target) \
                if served == 2 else None
            out["serve"] = wl.serve(requests=4)
            wl.request_hook = None
            out["sweep"] = wl.sweep(steps=2)
            out["spans"] = {k: span_names(svc, op["id"]) for k, op in out.items()}
            out["rows"] = wl.checkpoints()
        finally:
            svc.close()
    return out


@pytest.fixture(scope="module")
def jax_chain(tmp_path_factory):
    return _chain(tmp_path_factory.mktemp("jax_chain"), port=False)


@pytest.fixture(scope="module")
def port_chain(tmp_path_factory):
    return _chain(tmp_path_factory.mktemp("port_chain"), port=True)


# ------------------------------------------------------- world one ----
@pytest.mark.parametrize("verb", ["train", "drained", "resumed", "serve", "sweep"])
def test_ops_have_the_reference_shape(jax_chain, port_chain, verb):
    got, want = port_chain[verb], jax_chain[verb]
    assert got["status"] == want["status"] == OperationStatus.SUCCEEDED.value
    assert got["kind"] == want["kind"] and got["mesh"] == want["mesh"]
    assert sorted(got["result"]) == sorted(want["result"])
    assert port_chain["spans"][verb] == jax_chain["spans"][verb]
    for key in ("ok", "finite", "steps", "start_step", "end_step", "mode",
                "devices", "mesh", "drained", "served", "degraded", "axes"):
        assert got["result"].get(key) == want["result"].get(key), key
    if "losses" in want["result"]:
        np.testing.assert_allclose(got["result"]["losses"],
                                   want["result"]["losses"], rtol=LOSS_RTOL)


def test_drained_and_resumed_losses_equal_the_uninterrupted_run(
        jax_chain, port_chain):
    for chain in (port_chain, jax_chain):
        drained, resumed = chain["drained"]["result"], chain["resumed"]["result"]
        assert drained["drained"] and drained["end_step"] == 2
        assert resumed["start_step"] == 2 and resumed["end_step"] == 4
        assert chain["resumed"]["resumed_from"] == drained["checkpoint"]["id"]
        assert drained["losses"] + resumed["losses"] \
            == chain["train"]["result"]["losses"]


def test_checkpoint_rows_match_the_reference(jax_chain, port_chain):
    rows = {"port": port_chain["rows"], "jax": jax_chain["rows"]}
    assert [(r["step"], r["target_steps"], r["mesh"], r["bytes"], r["status"])
            for r in rows["port"]] \
        == [(r["step"], r["target_steps"], r["mesh"], r["bytes"], r["status"])
            for r in rows["jax"]]
    port_dir = port_chain["train"]["checkpoint"]["dir"]
    jax_dir = jax_chain["train"]["checkpoint"]["dir"]
    pman, jman = jck.verify_checkpoint(port_dir), jck.verify_checkpoint(jax_dir)
    assert [(l["path"], l["shape"], l["dtype"], l["bytes"]) for l in pman["leaves"]] \
        == [(l["path"], l["shape"], l["dtype"], l["bytes"]) for l in jman["leaves"]]
    # the reference's writer, handed the port's host tree, wrote what the
    # port's own writer writes for it: the same sha256 a leaf
    state, _ = pck.restore_checkpoint(port_dir, js.train_state_shapes())
    again = pck.save_checkpoint(str(port_dir) + "-again", state, step=4)
    assert [l["sha256"] for l in again["leaves"]] \
        == [l["sha256"] for l in pman["leaves"]]


def test_serve_answers_like_the_reference_through_a_reshard(jax_chain, port_chain):
    got, want = port_chain["serve"]["result"], jax_chain["serve"]["result"]
    assert got["served"] == want["served"] == 4 and got["degraded"] is True
    np.testing.assert_allclose(got["outputs"], want["outputs"], rtol=DIGEST_RTOL)
    assert got["checkpoint_restored"] == port_chain["resumed"]["checkpoint"]["id"]


def test_sweep_rows_match_the_reference(jax_chain, port_chain):
    got, want = port_chain["sweep"]["result"], jax_chain["sweep"]["result"]
    assert [sorted(r) for r in got["rows"]] == [sorted(r) for r in want["rows"]]
    for g, w in zip(got["rows"], want["rows"]):
        assert (g["axis"], g["devices"], g["mesh"], g["ok"]) \
            == (w["axis"], w["devices"], w["mesh"], w["ok"])
        np.testing.assert_allclose(g["losses"], w["losses"], rtol=LOSS_RTOL)


def test_queue_preemption_drill_at_world_one(tmp_path, monkeypatch):
    # tests/test_queue.py's drill on 2 slices x 1 chip: alice (low, 6 steps)
    # runs; at her step 2 bob (normal) and carol (high) arrive, carol
    # drains her; her two runs' losses are the uninterrupted run's
    use_port(monkeypatch, 1)
    uninterrupted = sw.run_training(WORLD_ONE, steps=6, device="cpu")["losses"]
    svc = queue_stack(tmp_path, queue={"slices": 2, "chips_per_slice": 1})
    try:
        fired = []

        def hook(completed, _loss):
            if completed == 2 and not fired:
                fired.append(True)
                for tenant, priority in (("bob", "normal"), ("carol", "high")):
                    svc.workload_queue.submit(mesh="data=1", steps=3,
                                              tenant=tenant, priority=priority,
                                              wait=True)

        svc.workloads.step_hook = hook
        svc.workload_queue.submit(mesh="data=1", steps=6, tenant="alice",
                                  priority="low", wait=True)
        svc.workloads.step_hook = None
        entries = {e["tenant"]: e for e in svc.workload_queue.entries()}
        assert all(entries[t]["state"] == "done" for t in ("alice", "bob", "carol"))
        led = entries["alice"]["preemptions"]
        assert len(led) == 1 and led[0]["kind"] == "drained"
        assert led[0]["by"] == entries["carol"]["id"] and led[0]["step"] == 2
        losses = []
        for op_id in entries["alice"]["run_ops"]:
            losses += svc.repos.operations.get(op_id).vars["result"]["losses"]
    finally:
        svc.close()
    assert losses == uninterrupted
    np.testing.assert_allclose(losses, jax_losses(WORLD_ONE, 6), rtol=LOSS_RTOL)


def _reshard_record(tmp_path, port: bool) -> tuple[dict, str]:
    tmp_path.mkdir()
    with pytest.MonkeyPatch.context() as mp:
        (use_port if port else use_devices)(mp, 1)
        svc = workload_stack(tmp_path)
        try:
            saved = svc.workloads.train(mesh="data=1", steps=3)["checkpoint"]
            op = svc.journal.open_scoped("slice-replace", message="drill",
                                         scope="workload")
            rec = svc.slicepool._reshard(JaxMeshSpec.parse(WORLD_ONE), op,
                                         svc.journal)
            names = span_names(svc, op.id)
        finally:
            svc.close()
    assert rec["resumed_from"] == saved["id"]
    return rec, names


def test_slicepool_reshard_record_matches_the_reference(tmp_path):
    got, got_spans = _reshard_record(tmp_path / "port", port=True)
    want, want_spans = _reshard_record(tmp_path / "jax", port=False)
    assert sorted(got) == sorted(want) and got_spans == want_spans
    assert got["ran"] and got["ok"] and got["start_step"] == want["start_step"] == 3
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)


def _corrupt_reshard_record(tmp_path, port: bool) -> tuple[dict, str]:
    """The degrade leg over a checkpoint with one shard's bytes flipped."""
    tmp_path.mkdir()
    with pytest.MonkeyPatch.context() as mp:
        (use_port if port else use_devices)(mp, 1)
        svc = workload_stack(tmp_path)
        try:
            saved = svc.workloads.train(mesh="data=1", steps=3)["checkpoint"]
            manifest = jck.verify_checkpoint(saved["dir"])
            shard = os.path.join(saved["dir"], manifest["leaves"][0]["file"])
            with open(shard, "r+b") as f:
                f.seek(-4, os.SEEK_END)
                f.write(b"\xff\xff\xff\xff")
            op = svc.journal.open_scoped("slice-replace", message="drill",
                                         scope="workload")
            rec = svc.slicepool._reshard(JaxMeshSpec.parse(WORLD_ONE), op,
                                         svc.journal)
            names = span_names(svc, op.id)
        finally:
            svc.close()
    return rec, names


def test_a_corrupt_checkpoint_degrades_to_a_from_scratch_reshard(tmp_path):
    # `_restore_latest` turns the restore's CheckpointError into a run
    # from scratch at `reshard_seed` instead of failing the replacement:
    # the port's error, injected, takes that path as the reference's does
    got, got_spans = _corrupt_reshard_record(tmp_path / "port", port=True)
    want, want_spans = _corrupt_reshard_record(tmp_path / "jax", port=False)
    assert sorted(got) == sorted(want) and got_spans == want_spans
    assert "reshard-restore" not in got_spans
    for rec in (got, want):
        assert rec["ran"] and rec["ok"] and "resumed_from" not in rec
        assert rec["start_step"] == 0 and rec["seed"] == 0
    scratch = sw.run_training(WORLD_ONE, steps=got["steps"], seed=0,
                              device="cpu")["losses"]
    assert got["losses"] == scratch
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)


# ------------------------------------------------- two relayed ranks ----
def test_two_ranks_through_the_relay(tmp_path, monkeypatch):
    # data=2: the uninterrupted run, then a drain at step 2 with a periodic
    # checkpoint every step, then a resume started on a worker thread
    # (`resume_from(wait=False)`); 3 spawns of 2 gloo ranks
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    use_port(monkeypatch, 2)
    svc = queue_stack(tmp_path, checkpoint={"every_steps": 1})
    try:
        wl = svc.workloads
        with one_spawn_at_a_time():
            full = wl.train(mesh="data=2", steps=4)
            seen = []
            drain = drain_at(svc, 2)

            def hook(completed, loss):
                seen.append((completed, loss))
                drain(completed, loss)

            wl.step_hook = hook
            drained = wl.train(mesh="data=2", steps=4)
            wl.step_hook = None
            wl.resume_from(wait=False)
            wl.wait_all(timeout_s=120.0)
        assert not wl._threads
        resumed = wl.list_ops()[0]
        rows = wl.checkpoints()
        drained_spans = span_names(svc, drained["id"])
    finally:
        svc.close()
    # the callbacks fired here, at each boundary, with float losses
    assert [c for c, _ in seen] == [1, 2]
    assert all(isinstance(loss, float) for _, loss in seen)
    assert resumed["status"] == OperationStatus.SUCCEEDED.value
    assert resumed["resumed_from"] == drained["checkpoint"]["id"]
    d, r = drained["result"], resumed["result"]
    assert d["drained"] and d["devices"] == 2 and r["start_step"] == 2
    assert d["losses"] + r["losses"] == full["result"]["losses"]
    np.testing.assert_allclose(full["result"]["losses"],
                               jax_losses("data=2,fsdp=1,tp=1", 4), rtol=LOSS_RTOL)
    # the drained run: a periodic save at step 1, the drain's at step 2
    drained_rows = [row["step"] for row in rows if row["op_id"] == drained["id"]]
    assert sorted(drained_rows) == [1, 2]
    assert drained_spans.count("checkpoint-save") == 2


def test_a_failing_rank_fails_the_op_naming_the_rank(tmp_path, monkeypatch):
    # 7 heads do not divide d_model 64: every rank's first step raises
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    use_port(monkeypatch, 2, cfg=pv.NetConfig(heads=7))
    svc = workload_stack(tmp_path)
    try:
        with one_spawn_at_a_time(), pytest.raises(KoError) as err:
            svc.workloads.train(mesh="data=2", steps=2)
        op = svc.workloads.list_ops()[0]
    finally:
        svc.close()
    assert re.search(r"rank [01] exited with code 1", str(err.value))
    assert "RankFailure" in op["message"] and "rank" in op["message"]
    assert op["status"] == OperationStatus.FAILED.value


def test_a_hung_rank_is_killed_and_reported():
    with rl.Relay(1, timeout_s=1.0) as relay:
        relay.start("import time; time.sleep(60)", {})
        with pytest.raises(rl.RankFailure, match=r"no event 0 .*rank\(s\) \[0\] "
                                                 r"still running, killed"):
            list(relay.events())
        assert all(p.poll() is not None for p in relay.procs)


# ---------------------------------------------------------- refusals ----
def test_a_mesh_larger_than_the_visible_count_is_refused():
    for seam in (sw.run_training, sw.run_serving):
        with pytest.raises(ValidationError, match="needs 2 devices, 1 visible"):
            seam({"data": 2, "fsdp": 1, "tp": 1}, device="cpu", visible=[0])
    with pytest.raises(ValidationError, match="at least 1 rank"):
        sw.visible_devices("cpu", 0)
    assert sw.visible_devices("cpu") == [0]


def test_a_bf16_host_tree_is_refused_before_the_run():
    cfg = pv.NetConfig(dtype="bfloat16")
    for kw in ({"return_state": True}, {"on_checkpoint": lambda *_: None}):
        with pytest.raises(ValidationError, match="ml_dtypes"):
            sw.run_training(WORLD_ONE, cfg=cfg, device="cpu", **kw)
    assert sw.run_training(WORLD_ONE, cfg=cfg, steps=2, device="cpu")["finite"]


def test_an_in_process_run_leaves_the_process_group_as_it_found_it():
    before = dist.is_initialized()
    ran = []
    thread = threading.Thread(target=lambda: ran.append(
        sw.run_training(WORLD_ONE, steps=2, device="cpu")))
    thread.start()
    thread.join(60)
    assert not thread.is_alive() and ran[0]["ok"]
    assert dist.is_initialized() == before


# ------------------------------------------------------- duck typing ----
def test_mesh_axes_reads_jax_meshes_and_specs():
    want = MeshSpec.parse("data=2,fsdp=2,tp=1")
    jspec = JaxMeshSpec.parse("data=2,fsdp=2,tp=1")
    jmesh = jspec.build(jax.devices()[:4])
    assert not hasattr(jmesh, "axes")
    for like in (jmesh, jspec, want, {"data": 2, "fsdp": 2, "tp": 1},
                 "data=2,fsdp=2,tp=1"):
        assert sw.mesh_axes(like) == want
    with pytest.raises(TopologyError, match="cannot read mesh axes"):
        sw.mesh_axes(4)


def test_restore_reads_a_shape_dtype_struct_template(tmp_path):
    # the reference's template: jax.ShapeDtypeStruct leaves (numpy and
    # ml_dtypes dtypes) in optax's containers
    template = js.train_state_shapes()
    assert type(ppart.tree_paths(template)[0][1]).__name__ == "ShapeDtypeStruct"
    assert pck._dtype_name(np.dtype("float32")) == "float32"
    bf16 = js.train_state_shapes(jv.NetConfig(dtype="bfloat16"))
    assert type(bf16["params"]["wqkv"].dtype).__module__ != "torch"
    assert pck._dtype_name(bf16["params"]["wqkv"].dtype) == "bfloat16"
    assert pck._dtype_name(torch.bfloat16) == "bfloat16"
    host = js.build_host_state(seed=5)
    man = jck.save_checkpoint(str(tmp_path), host, step=0)
    state, _ = pck.restore_checkpoint(man["dir"], template)
    assert type(state["opt"][0]) is type(template["opt"][0])
    want = dict(jpart.tree_paths(jax.tree_util.tree_map(np.asarray, host)))
    for path, leaf in ppart.tree_paths(state):
        np.testing.assert_array_equal(leaf, want[path], err_msg=path)
