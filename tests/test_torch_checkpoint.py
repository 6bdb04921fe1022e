"""The port's checkpoints against the JAX package's, on the host: the same
host TrainState saved by both packages gives the same leaf list, file
names, bytes and sha256 at f32 and at bf16; an f32 checkpoint saved by one
package resumes in the other on the uninterrupted trajectory; a bf16
checkpoint is refused by both, naming the same leaf (a defect of the
reference that the port reproduces: `np.save` writes a bfloat16 leaf as
``<V2``, which reads back as ``|V2`` and fails the dtype check); and
`sweep_torn`, `verify_checkpoint` and `load_manifest` act alike on the
same directories.

Tolerance: resumed losses within 1e-5 relative of the other package's
uninterrupted run (f32 sums in other orders; the state handed across
differs in its last bits). Within one package the resumed losses are the
uninterrupted ones exactly.
"""

import os
import shutil

import jax
import numpy as np
import pytest

from kubeoperator_tpu.parallel import validation_net as jv
from kubeoperator_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from kubeoperator_tpu.workloads import checkpoint as jck
from kubeoperator_tpu.workloads import harness as jh
from kubeoperator_tpu.workloads import step as js
from kubeoperator_tpu_torch.parallel import validation_net as pv
from kubeoperator_tpu_torch.parallel.mesh import MeshSpec
from kubeoperator_tpu_torch.parallel.multislice import initialize_from_env
from kubeoperator_tpu_torch.workloads import checkpoint as pck
from kubeoperator_tpu_torch.workloads import harness as ph
from kubeoperator_tpu_torch.workloads import partition as ppart
from kubeoperator_tpu_torch.workloads import step as ps

LOSS_RTOL = 1e-5
WORLD_ONE = "data=1,fsdp=1,tp=1"
LEAF_KEYS = ("path", "file", "sha256", "shape", "dtype", "bytes")


def _jax_host(state):
    return jax.tree_util.tree_map(np.asarray, state)


def _port_host(jax_host):
    """The reference's host TrainState as the port's (CPU tensors)."""
    return ppart.tree_map(ppart.as_tensor, jax_host)


def _leaves(manifest):
    return [tuple(l[k] if k != "shape" else tuple(l[k]) for k in LEAF_KEYS)
            for l in manifest["leaves"]]


def _port_mesh():
    initialize_from_env("cpu")
    return MeshSpec.parse(WORLD_ONE).build("cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("state", ["fresh", "trained"])
def test_both_packages_write_the_same_files(tmp_path, dtype, state):
    if state == "fresh":
        jhost = _jax_host(js.build_host_state(jv.NetConfig(dtype=dtype), 5))
        phost = ps.build_host_state(pv.NetConfig(dtype=dtype), 5)
    else:   # moments off zero: the reference's state after 2 steps
        run = jh.run_training(JaxMeshSpec.parse(WORLD_ONE).build(),
                              jv.NetConfig(dtype=dtype), steps=2,
                              return_state=True)
        jhost = _jax_host(run["state"])
        phost = _port_host(jhost)
    ref = jck.save_checkpoint(str(tmp_path / "jax"), jhost, step=2,
                              checkpoint_id="c")
    got = pck.save_checkpoint(str(tmp_path / "port"), phost, step=2,
                              checkpoint_id="c")
    assert _leaves(got) == _leaves(ref)
    assert len(got["leaves"]) == 16
    assert {l["dtype"] for l in got["leaves"] if l["path"] != "opt/0/count"
            and not l["path"].endswith("/step")} == {dtype}
    assert sorted(os.listdir(got["dir"])) == sorted(os.listdir(ref["dir"]))
    for leaf in got["leaves"]:
        with open(os.path.join(got["dir"], leaf["file"]), "rb") as a, \
                open(os.path.join(ref["dir"], leaf["file"]), "rb") as b:
            assert a.read() == b.read(), leaf["path"]
    assert set(got) == set(ref)
    for key in ("format", "id", "step", "target_steps", "mesh", "seed",
                "losses", "total_bytes"):
        assert got[key] == ref[key], key


def test_leaf_bytes_match_for_a_bf16_leaf():
    import ml_dtypes

    a = (np.random.default_rng(0).standard_normal((3, 5)) * 0.05) \
        .astype(ml_dtypes.bfloat16)
    assert pck.leaf_to_bytes(ppart.as_tensor(a)) == jck.leaf_to_bytes(a)
    assert pck.leaf_to_bytes(a) == jck.leaf_to_bytes(a)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    jmesh = JaxMeshSpec.parse(WORLD_ONE).build()
    full = jh.run_training(jmesh, steps=6, seed=0)
    part = jh.run_training(jmesh, steps=3, seed=0, return_state=True)
    man = jck.save_checkpoint(str(tmp_path), _jax_host(part.pop("state")),
                              step=3, target_steps=6, mesh=part["mesh"])
    back, manifest = pck.restore_checkpoint(man["dir"], ps.train_state_shapes())
    assert manifest["id"] == man["id"]
    mesh = _port_mesh()
    resumed = ph.run_training(mesh, steps=3, seed=0, state=back)
    assert (resumed["start_step"], resumed["end_step"]) == (3, 6)
    np.testing.assert_allclose(part["losses"] + resumed["losses"],
                               full["losses"], rtol=LOSS_RTOL)
    own = ph.run_training(mesh, steps=6, seed=0)
    np.testing.assert_allclose(resumed["losses"], own["losses"][3:],
                               rtol=LOSS_RTOL)


def test_port_checkpoint_resumes_in_jax_and_in_the_port(tmp_path):
    mesh = _port_mesh()
    full = ph.run_training(mesh, steps=6, seed=0)
    part = ph.run_training(mesh, steps=3, seed=0, return_state=True)
    _, specs, _ = ps.make_train_step(mesh)
    _, gather = ppart.make_shard_and_gather_fns(mesh, specs)
    man = pck.save_checkpoint(str(tmp_path), gather(part.pop("state")),
                              step=3, target_steps=6, mesh=part["mesh"])
    # the port on its own checkpoint: the uninterrupted losses exactly
    back, _ = pck.restore_checkpoint(man["dir"], ps.train_state_shapes())
    again = ph.run_training(mesh, steps=3, seed=0, state=back)
    assert part["losses"] + again["losses"] == full["losses"]
    # the reference on the port's checkpoint
    jback, _ = jck.restore_checkpoint(man["dir"], js.train_state_shapes())
    jmesh = JaxMeshSpec.parse(WORLD_ONE).build()
    resumed = jh.run_training(jmesh, steps=3, seed=0, state=jback)
    assert (resumed["start_step"], resumed["end_step"]) == (3, 6)
    ref_full = jh.run_training(jmesh, steps=6, seed=0)
    np.testing.assert_allclose(resumed["losses"], ref_full["losses"][3:],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(part["losses"] + resumed["losses"],
                               full["losses"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_bf16_checkpoint_is_refused_by_both_naming_the_same_leaf(tmp_path, saver):
    if saver == "jax":
        man = jck.save_checkpoint(
            str(tmp_path), _jax_host(js.build_host_state(jv.NetConfig(dtype="bfloat16"))),
            step=0)
    else:
        man = pck.save_checkpoint(
            str(tmp_path), ps.build_host_state(pv.NetConfig(dtype="bfloat16")), step=0)
    with pytest.raises(jck.CheckpointError) as ref:
        jck.restore_checkpoint(man["dir"],
                               js.train_state_shapes(jv.NetConfig(dtype="bfloat16")))
    with pytest.raises(pck.CheckpointError) as got:
        pck.restore_checkpoint(man["dir"],
                               ps.train_state_shapes(pv.NetConfig(dtype="bfloat16")))
    assert str(got.value) == str(ref.value)
    assert "leaf opt/0/mu/w_head is (64, 64)/|V2, the live TrainState wants " \
           "(64, 64)/bfloat16" in str(got.value)


def test_restore_refuses_another_model_config(tmp_path):
    man = pck.save_checkpoint(str(tmp_path), ps.build_host_state(), step=0)
    wider = pv.NetConfig(d_model=128)
    with pytest.raises(pck.CheckpointError) as got:
        pck.restore_checkpoint(man["dir"], ps.train_state_shapes(wider))
    with pytest.raises(jck.CheckpointError) as ref:
        jck.restore_checkpoint(man["dir"], js.train_state_shapes(jv.NetConfig(d_model=128)))
    assert str(got.value) == str(ref.value)


def _layout(root):
    """A root with every case the sweep tells apart: a complete checkpoint,
    one with a stranded tmp file, a torn one (no manifest), a tenant
    namespace holding one of each, an empty directory, and a plain file."""
    host = ps.build_host_state()
    for name in ("good", "stray"):
        pck.save_checkpoint(root, host, step=1, checkpoint_id=name)
    with open(os.path.join(root, "stray", "x.npy.tmp-1-abc"), "wb") as f:
        f.write(b"half")
    os.makedirs(os.path.join(root, "torn"))
    with open(os.path.join(root, "torn", "params-step-00.npy"), "wb") as f:
        f.write(b"x")
    pck.save_checkpoint(os.path.join(root, "tenant"), host, step=1,
                        checkpoint_id="kept")
    os.makedirs(os.path.join(root, "tenant", "torn-too"))
    os.makedirs(os.path.join(root, "empty"))
    with open(os.path.join(root, "README"), "w") as f:
        f.write("not a checkpoint")


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files + [""])


@pytest.mark.parametrize("min_age_s", [0.0, pck.TORN_MIN_AGE_S])
def test_sweep_torn_matches_reference(tmp_path, min_age_s):
    assert pck.TORN_MIN_AGE_S == jck.TORN_MIN_AGE_S
    port_root, ref_root = str(tmp_path / "port"), str(tmp_path / "ref")
    _layout(port_root)
    shutil.copytree(port_root, ref_root)
    got = [os.path.relpath(p, port_root) for p in pck.sweep_torn(port_root, min_age_s)]
    want = [os.path.relpath(p, ref_root) for p in jck.sweep_torn(ref_root, min_age_s)]
    assert got == want
    assert _tree(port_root) == _tree(ref_root)
    if min_age_s == 0.0:
        assert got == ["empty", "stray/x.npy.tmp-1-abc", "tenant/torn-too", "torn"]
    else:
        assert got == []      # a fresh manifest-less dir may be a peer's save


def test_verify_and_load_manifest_match_reference(tmp_path):
    man = pck.save_checkpoint(str(tmp_path), ps.build_host_state(), step=1)
    assert pck.verify_checkpoint(man["dir"]) == jck.verify_checkpoint(man["dir"])
    assert pck.manifest_sha(man) == jck.manifest_sha(man)

    def both(fn_name, *args):
        out = []
        for mod in (pck, jck):
            try:
                getattr(mod, fn_name)(*args)
            except mod.CheckpointError as e:
                out.append(str(e))
        return out

    shard = os.path.join(man["dir"], man["leaves"][3]["file"])
    with open(shard, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        f.write(b"\x7f")
    got, want = both("verify_checkpoint", man["dir"])
    assert got == want and "failed hash verification" in got
    got = _restore_error(pck, man["dir"], ps.train_state_shapes())
    want = _restore_error(jck, man["dir"], js.train_state_shapes())
    assert got == want and "content hash mismatch" in got
    os.remove(shard)
    got, want = both("verify_checkpoint", man["dir"])
    assert got == want and "unreadable" in got
    manifest = os.path.join(man["dir"], pck.MANIFEST_NAME)
    pck.atomic_write_json(manifest, dict(man, format=2))
    got, want = both("load_manifest", man["dir"])
    assert got == want and "unsupported checkpoint format" in got
    os.remove(manifest)
    got, want = both("load_manifest", man["dir"])
    assert got == want and "no readable" in got


def _restore_error(mod, directory, like) -> str:
    with pytest.raises(mod.CheckpointError) as e:
        mod.restore_checkpoint(directory, like)
    return str(e.value)


def test_atomic_write_leaves_no_tmp_file(tmp_path):
    path = str(tmp_path / "f.bin")
    pck.atomic_write_bytes(path, b"one")
    pck.atomic_write_bytes(path, b"two")
    assert os.listdir(tmp_path) == ["f.bin"]
    with open(path, "rb") as f:
        assert f.read() == b"two"
    assert (pck.MANIFEST_NAME, pck.CHECKPOINT_FORMAT) \
        == (jck.MANIFEST_NAME, jck.CHECKPOINT_FORMAT)
