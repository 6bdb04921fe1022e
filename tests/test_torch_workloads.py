"""The port's tenant training workload against the JAX package's, on the
host: the partition-rule engine (tree paths, `match_partition_rules`,
`explain_rules` JSON), the TrainState's leaves, AdamW against
`optax.adamw`, the step's `PartitionError` cases, `run_training` at world
1 in both modes, and at 4 gloo ranks (one module-scoped spawn) on meshes
(data, fsdp, tp) = (4,1,1), (1,4,1), (1,1,4), (2,2,1), (1,2,2) in both
modes, the pjit step on layouts outside the plain Megatron pair (`LAYOUTS`)
on (1,1,4) and (1,2,2), and the scaling sweep over subset meshes, against
JAX on virtual devices of the same shapes.

Tolerances, and why:
- AdamW alone, bf16: bit for bit (each bf16 operation rounds in both).
  f32: XLA contracts the moment updates into fused multiply-adds (one
  rounding where eager PyTorch rounds twice), so moments agree within
  1e-6 of the leaf's largest magnitude (a moment near 0 after a sign change
  carries the rounding of its larger terms) and parameters within 1e-7
  absolute (about 2 f32 steps at their 0.05-0.2 magnitude).
- Training losses: 1e-5 relative (same f32 arithmetic in other summation
  orders; they agree to about 1e-7).
- Final TrainState after `STEPS` AdamW steps: moments within 1e-5
  relative (1e-7 absolute for mu, 1e-12 for nu). Parameters within 1e-6
  absolute, except where a gradient entry is small against the rounding
  of its sum: Adam divides each update by the entry's own gradient scale,
  so the noise comes back at full size (its first update is lr·sign(g):
  an entry within noise of 0 can move the other way by 2·lr in one
  package). Such entries must be rare (at most 0.5% of a leaf; about 0.1%
  is seen, those whose moment is under 6% of the leaf's largest) and stay
  within 2·lr·STEPS.
"""

import dataclasses
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from kubeoperator_tpu.parallel import validation_net as jv
from kubeoperator_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from kubeoperator_tpu.workloads import harness as jh
from kubeoperator_tpu.workloads import partition as jpart
from kubeoperator_tpu.workloads import step as js
from kubeoperator_tpu_torch.parallel import validation_net as pv
from kubeoperator_tpu_torch.parallel.mesh import MeshSpec
from kubeoperator_tpu_torch.parallel.multislice import initialize_from_env
from kubeoperator_tpu_torch.weights import host_tensor
from kubeoperator_tpu_torch.workloads import harness as ph
from kubeoperator_tpu_torch.workloads import partition as ppart
from kubeoperator_tpu_torch.workloads import step as ps

from tests.test_torch_ops import spawn_ranks

LOSS_RTOL = 1e-5
MU_RTOL, MU_ATOL, NU_ATOL = 1e-5, 1e-7, 1e-12
PARAM_ATOL, NOISY_SHARE = 1e-6, 5e-3
STEPS = 4
MESHES = [(4, 1, 1), (1, 4, 1), (1, 1, 4), (2, 2, 1), (1, 2, 2)]
MODES = ("pjit", "shard_map")


def _spec(sizes) -> str:
    return ",".join(f"{a}={n}" for a, n in zip(ps.WORKLOAD_AXES, sizes))


def _np(leaf) -> np.ndarray:
    """A leaf of either package as a float64 (or int) numpy array."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.float() if leaf.is_floating_point() else leaf
        return leaf.numpy().astype(np.float64 if leaf.is_floating_point()
                                   else np.int64)
    a = np.asarray(leaf)
    return a.astype(np.int64) if a.dtype.kind == "i" else a.astype(np.float64)


def assert_state_close(port: dict, ref: dict, steps: int, lr: float = ps.ADAMW_LR):
    """`port` and `ref`: {path: leaf} of a final TrainState (module
    docstring's tolerances)."""
    assert list(port) == list(ref)
    for path, want in ref.items():
        got, want = _np(port[path]), _np(want)
        assert got.shape == want.shape, path
        if "/mu/" in path:
            np.testing.assert_allclose(got, want, rtol=MU_RTOL, atol=MU_ATOL,
                                       err_msg=path)
        elif "/nu/" in path:
            np.testing.assert_allclose(got, want, rtol=MU_RTOL, atol=NU_ATOL,
                                       err_msg=path)
        elif path.startswith("params/"):
            off = np.abs(got - want)
            assert (off > PARAM_ATOL).mean() <= NOISY_SHARE, path
            assert off.max() <= 2 * lr * steps, path
        else:
            np.testing.assert_array_equal(got, want, err_msg=path)


# --------------------------------------------------------- rule engine ----
def test_train_state_leaves_are_the_reference_leaves():
    for cfg in ("default", "bf16", "bench"):
        jcfg, pcfg = {"default": (jv.NetConfig(), pv.NetConfig()),
                      "bf16": (jv.NetConfig(dtype="bfloat16"),
                               pv.NetConfig(dtype="bfloat16")),
                      "bench": (jv.BENCH_CONFIG, pv.BENCH_CONFIG)}[cfg]
        ref = jpart.tree_paths(js.train_state_shapes(jcfg))
        got = ppart.tree_paths(ps.train_state_shapes(pcfg))
        assert [p for p, _ in got] == [p for p, _ in ref]
        assert len(got) == 16
        assert sum(p.startswith("opt/0/") for p, _ in got) == 11
        for (path, g), (_, r) in zip(got, ref):
            assert tuple(g.shape) == tuple(r.shape), path
            assert str(g.dtype).removeprefix("torch.") == str(np.dtype(r.dtype)), path


def test_tree_paths_name_every_container_like_jax():
    from collections import namedtuple

    Pair = namedtuple("Pair", ["zeta", "alpha"])
    tree = {"b": [np.ones(2), (np.ones(3), None)],
            "a": Pair(zeta=np.ones(1), alpha={"y": np.ones(4), "x": 1.0}),
            "c": None}
    ref = [p for p, _ in jpart.tree_paths(tree)]
    assert [p for p, _ in ppart.tree_paths(tree)] == ref
    assert ref == ["a/zeta", "a/alpha/x", "a/alpha/y", "b/0", "b/1/0"]
    # the map keeps every container's type and a dict its key order
    mapped = ppart.tree_map(lambda leaf: np.shape(leaf), tree)
    assert isinstance(mapped["a"], Pair) and list(mapped) == ["b", "a", "c"]
    assert mapped["b"][1] == ((3,), None)


def test_opt_state_indexes_like_optax():
    host = ps.build_host_state()
    ref = js.build_host_state()
    assert host["opt"][0].mu["wqkv"].shape == ref["opt"][0].mu["wqkv"].shape
    assert host["opt"][0].count.dtype == torch.int32
    assert type(host["opt"][1]).__name__ == type(ref["opt"][1]).__name__
    assert [type(s).__name__ for s in host["opt"]] \
        == [type(s).__name__ for s in ref["opt"]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_host_state_is_the_reference_bit_for_bit(dtype):
    ref = dict(jpart.tree_paths(js.build_host_state(jv.NetConfig(dtype=dtype), 3)))
    got = dict(ppart.tree_paths(ps.build_host_state(pv.NetConfig(dtype=dtype), 3)))
    assert list(got) == list(ref)
    for path, want in ref.items():
        want, have = np.asarray(want), got[path]
        assert str(have.dtype).removeprefix("torch.") == want.dtype.name, path
        assert torch.equal(host_tensor(want), have), path


# rule lists, good and bad, one table for both packages; specs are written
# once as tuples and given to JAX as PartitionSpecs
RULE_TABLE = {
    "default": [(r"wqkv$", ("fsdp", None)), (r"w_in$", (None, "tp")),
                (r"w_out$", ("tp", None)), (r"w_head$", (None, None))],
    "catch_all_first": [(r".*", (None, "tp")), (r"wqkv$", ("fsdp", None))],
    "grouped_axes": [(r"wqkv$", (("data", "fsdp"), None)),
                     (r"w_(in|out)$", (None, None)),
                     (r"never_fires$", ("tp", None)), (r"w_head$", ())],
    "moments_only": [(r"opt/0/(mu|nu)/.*", ("fsdp",)), (r"params/", ())],
    "missing_head": [(r"wqkv$", ("fsdp", None)), (r"w_(in|out)$", (None, None))],
    "empty": [],
}


def _jax_rules(rules):
    return [(pattern, P(*spec)) for pattern, spec in rules]


@pytest.mark.parametrize("name", RULE_TABLE)
def test_rule_engine_matches_reference(name):
    rules = RULE_TABLE[name]
    jshapes, pshapes = js.train_state_shapes(), ps.train_state_shapes()
    ref = jpart.explain_rules(_jax_rules(rules), jshapes)
    got = ppart.explain_rules(rules, pshapes)
    assert json.dumps(got) == json.dumps(ref)

    def outcome(fn):
        try:
            return ("ok", fn())
        except (jpart.PartitionError, ppart.PartitionError) as e:
            return ("error", type(e).__name__, str(e))

    want = outcome(lambda: _spec_leaves(
        jpart.match_partition_rules(_jax_rules(rules), jshapes), jshapes))
    have = outcome(lambda: _spec_leaves(
        ppart.match_partition_rules(rules, pshapes), pshapes))
    assert have == want


def _spec_leaves(specs, shapes):
    """[(path, spec as a tuple)] of a spec tree of either package, walked
    along its shape tree (a spec is a tuple, so it cannot lead the walk)."""
    out = []
    ppart.tree_map_with_path(
        lambda path, _, spec: out.append((path, tuple(spec))), shapes, specs)
    return out


def test_unmatched_leaf_error_names_the_path():
    # the first unmatched leaf in the reference's order: a moment, before
    # the params
    with pytest.raises(ppart.PartitionError, match=re.escape("'opt/0/mu/w_head'")):
        ppart.match_partition_rules(RULE_TABLE["missing_head"],
                                    ps.train_state_shapes())


# ------------------------------------------------------------- AdamW ----
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_optax(dtype):
    jcfg, pcfg = jv.NetConfig(dtype=dtype), pv.NetConfig(dtype=dtype)
    jp = {k: jnp.asarray(v) for k, v in js.build_host_params(jcfg, 2).items()}
    pp = ps.build_host_params(pcfg, 2)
    opt, popt = js.make_optimizer(), ps.make_optimizer()
    jstate, pstate = opt.init(jp), popt.init(pp)
    update = jax.jit(opt.update)
    rng = np.random.default_rng(11)
    for _ in range(4):
        g = {k: rng.standard_normal(np.shape(v)) * 0.01 for k, v in jp.items()}
        g["step"] = np.zeros(())
        jg = {k: jnp.asarray(v, dtype=jp[k].dtype) for k, v in g.items()}
        u, jstate = update(jg, jstate, jp)
        jp = optax.apply_updates(jp, u)
        pu, pstate = popt.update({k: host_tensor(np.asarray(v)) for k, v in jg.items()},
                                 pstate, pp)
        pp = ps.apply_updates(pp, pu)
    assert int(pstate[0].count) == int(jstate[0].count) == 4
    assert pstate[0].count.dtype == torch.int32
    pairs = [("params", pp, jp), ("mu", pstate[0].mu, jstate[0].mu),
             ("nu", pstate[0].nu, jstate[0].nu)]
    for what, got, want in pairs:
        for k in want:
            g, w = _np(got[k]), _np(want[k])
            assert got[k].dtype == ps.param_shapes(pcfg)[k].dtype, (what, k)
            if dtype == "bfloat16":
                np.testing.assert_array_equal(g, w, err_msg=f"{what}/{k}")
            elif what == "params":
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-7,
                                           err_msg=f"{what}/{k}")
            else:
                np.testing.assert_allclose(g, w, rtol=0,
                                           atol=1e-6 * np.abs(w).max(),
                                           err_msg=f"{what}/{k}")
    # the step counter neither decays nor moves under the update
    assert float(pp["step"]) == 0.0


# -------------------------------------------------- the step's errors ----
def _world_one(spec="data=1,fsdp=1,tp=1"):
    initialize_from_env("cpu")
    return MeshSpec.parse(spec).build("cpu")


def _errors(fn):
    try:
        fn()
    except Exception as e:   # noqa: BLE001 - compared across packages
        return type(e).__name__, str(e)
    return None


def test_partition_errors_match_reference():
    mesh, jmesh = _world_one(), JaxMeshSpec.parse("data=1,fsdp=1,tp=1").build()
    pspecs = ppart.match_partition_rules(ps.default_rules(), ps.train_state_shapes())
    jspecs = jpart.match_partition_rules(js.default_rules(), js.train_state_shapes())
    pparams = ppart.match_partition_rules(ps.default_rules(), ps.param_shapes())
    jparams = jpart.match_partition_rules(js.default_rules(), js.param_shapes())
    cases = {
        "pjit without specs": (lambda: ps.compile_step(mesh, specs=None, mode="pjit"),
                               lambda: js.compile_step(jmesh, specs=None, mode="pjit")),
        "params-only specs": (lambda: ps.compile_step(mesh, specs=pparams, mode="pjit"),
                              lambda: js.compile_step(jmesh, specs=jparams, mode="pjit")),
        "unknown mode": (lambda: ps.compile_step(mesh, specs=pspecs, mode="gspmd"),
                         lambda: js.compile_step(jmesh, specs=jspecs, mode="gspmd")),
        "unmatched rule": (
            lambda: ps.make_train_step(mesh, rules=RULE_TABLE["missing_head"]),
            lambda: js.make_train_step(jmesh, rules=_jax_rules(RULE_TABLE["missing_head"]))),
    }
    for what, (port, ref) in cases.items():
        got, want = _errors(port), _errors(ref)
        assert want is not None and want[0] == "PartitionError", what
        assert got == want, what
    # a mesh without the workload's axes
    flat = MeshSpec.parse("dp=1").build("cpu")
    got = _errors(lambda: ps.compile_step(flat))
    want = _errors(lambda: js.compile_step(JaxMeshSpec.parse("dp=8").build()))
    assert got == want and got[0] == "PartitionError"
    # auto picks pjit with specs and shard_map without, as the reference
    assert ps.compile_step(mesh, specs=pspecs)[1] == "pjit"
    assert ps.compile_step(mesh, specs=None)[1] == "shard_map"


# ------------------------------------------------------- world one ----
def _flat_host(state):
    return {p: leaf for p, leaf in jpart.tree_paths(
        jax.tree_util.tree_map(np.asarray, state))}


@pytest.mark.parametrize("mode", MODES)
def test_run_training_matches_jax_at_world_one(mode):
    spec = "data=1,fsdp=1,tp=1"
    ref = jh.run_training(JaxMeshSpec.parse(spec).build(), steps=6, mode=mode,
                          return_state=True)
    got = ph.run_training(_world_one(spec), steps=6, mode=mode, return_state=True)
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_RTOL)
    assert got["losses"][-1] < got["losses"][0] and got["ok"]
    assert_state_close(dict(ppart.tree_paths(got.pop("state"))),
                       _flat_host(ref.pop("state")), steps=6)
    assert sorted(got) == sorted(ref)
    for key in ("ok", "finite", "descending", "steps", "start_step", "end_step",
                "stopped_early", "mode", "devices", "mesh"):
        assert got[key] == ref[key], key
    assert [w["name"] for w in got["windows"]] == ["compile", "steps"]
    assert got["windows"][0]["attrs"] == ref["windows"][0]["attrs"]


def test_run_training_seams():
    mesh = _world_one()
    seen, saved = [], []
    run = ph.run_training(mesh, steps=5, on_step=lambda n, _: seen.append(n) or n == 4,
                          checkpoint_every=2,
                          on_checkpoint=lambda n, s: saved.append(
                              (n, float(s["params"]["step"]))))
    assert seen == [1, 2, 3, 4] and run["stopped_early"] and run["steps"] == 4
    assert saved == [(2, 2.0)] and run["end_step"] == 4
    # a save never lands on the final step
    saved.clear()
    ph.run_training(mesh, steps=4, checkpoint_every=2,
                    on_checkpoint=lambda n, s: saved.append(n))
    assert saved == [2]


def test_analytic_step_flops_match_reference():
    for sizes in [(1, 1, 1)] + MESHES:
        shape = dict(zip(ps.WORKLOAD_AXES, sizes))
        mesh = JaxMeshSpec(axes=tuple(shape.items()))
        for jcfg, pcfg in ((jv.NetConfig(), pv.NetConfig()),
                           (jv.BENCH_CONFIG, pv.BENCH_CONFIG)):
            assert ps.analytic_step_flops(MeshSpec(axes=tuple(shape.items())), pcfg) \
                == js.analytic_step_flops(type("M", (), {"shape": shape}), jcfg)
    one = MeshSpec.parse("data=1,fsdp=1,tp=1")
    # the bound chip_smoke.py quotes: 1.0143e14 FLOP a step at BENCH_CONFIG
    assert ps.analytic_step_flops(one, pv.BENCH_CONFIG) == pytest.approx(1.0143e14, rel=1e-4)


def test_row_schema_and_sweep_plan_match_reference():
    assert ph.ROW_SCHEMA == jh.ROW_SCHEMA
    assert ph.WORKLOAD_AXES == js.WORKLOAD_AXES and ps.DATA_AXES == js.DATA_AXES
    assert (ps.ADAMW_LR, ps.ADAMW_WEIGHT_DECAY) == (js.ADAMW_LR, js.ADAMW_WEIGHT_DECAY)
    assert [(p, tuple(s)) for p, s in ps.default_rules()] \
        == [(p, tuple(s)) for p, s in js.default_rules()]
    for n in range(1, 9):
        for axes in (ps.WORKLOAD_AXES, ("data", "tp"), ("fsdp",)):
            assert [s.axes for s in ph.sweep_specs(n, axes)] \
                == [s.axes for s in jh.sweep_specs(n, axes)]


def test_harness_entry_point_at_world_one(capsys):
    initialize_from_env("cpu")
    assert ph.main(["--cpu"]) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("KO_TPU_WORKLOAD_RESULT ")]
    report = json.loads(line[0].split(" ", 1)[1])
    assert report["ok"] and report["devices"] == 1
    assert "peak_tflops_per_chip" not in report       # no card, no peak
    assert set(report["baseline"]) == set(ph.ROW_SCHEMA)


# ------------------------------------------------------- 4 gloo ranks ----
_RANK_SCRIPT = """
import json, os, numpy as np, torch, torch.distributed as dist
from kubeoperator_tpu_torch.parallel.mesh import MeshSpec
from kubeoperator_tpu_torch.parallel.multislice import initialize_from_env
from kubeoperator_tpu_torch.workloads import harness, partition, step
initialize_from_env("cpu")
rank = dist.get_rank()
res = {{"rank": rank, "runs": {{}}}}
def train(key, sizes, mode, rules=None):
    mesh = MeshSpec(axes=tuple(zip(step.WORKLOAD_AXES, sizes))).build()
    run = harness.run_training(mesh, steps={steps}, mode=mode, rules=rules,
                               return_state=True)
    state = run.pop("state")
    _, specs, _ = step.make_train_step(mesh, rules=rules, mode=mode)
    if specs is None:
        specs = partition.replicated_specs(state)
    _, gather = partition.make_shard_and_gather_fns(mesh, specs)
    host = dict(partition.tree_paths(gather(state)))
    if rank == 0:
        np.savez(os.path.join({out!r}, key.replace("/", "-") + ".npz"),
                 **{{k.replace("/", "|"): v.float().numpy() if v.is_floating_point()
                    else v.numpy() for k, v in host.items()}})
    res["runs"][key] = {{k: v for k, v in run.items() if k != "windows"}}
for sizes in {meshes}:
    for mode in {modes}:
        train(f"{{sizes}}/{{mode}}", sizes, mode)
for name, rules in {layouts}.items():
    for sizes in {layout_meshes}:
        train(f"{{name}}/{{sizes}}", sizes, "pjit", rules)
res["sweep"] = harness.run_sweep(steps=2)
dist.barrier()
print("RANK_RESULT " + json.dumps(res), flush=True)
os._exit(0)
"""

# layouts the explicit step runs outside the plain Megatron pair: tp cuts
# on other leaves or dims (gathered on use, gradient sliced back), half a
# pair, tp inside a group of axes, and Adam moments laid out apart from
# their params (re-cut around the update); on two 4-rank meshes, against
# the reference's jax.jit of the same spec tree
LAYOUTS = {
    "tp_on_wqkv": [(r"wqkv$", ("tp", None)), (r".*", ())],
    "half_pair": [(r"w_in$", (None, "tp")), (r".*", ())],
    "tp_in_a_group": [(r"w_in$", (None, ("fsdp", "tp"))),
                      (r"w_out$", ("tp", None)), (r".*", ())],
    "moments_apart": [(r"params/wqkv$", ("fsdp", None)), (r".*", ())],
}
LAYOUT_MESHES = [(1, 1, 4), (1, 2, 2)]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("workload_states")
    script = _RANK_SCRIPT.format(meshes=[tuple(m) for m in MESHES],
                                 modes=MODES, steps=STEPS, out=str(out),
                                 layouts=LAYOUTS, layout_meshes=LAYOUT_MESHES)
    return spawn_ranks(4, script, timeout=300), out


@pytest.fixture(scope="module")
def jax_runs():
    runs = {}
    for sizes in MESHES:
        for mode in MODES:
            run = jh.run_training(JaxMeshSpec.parse(_spec(sizes)).build(),
                                  steps=STEPS, mode=mode, return_state=True)
            run["state"] = _flat_host(run["state"])
            runs[f"{tuple(sizes)}/{mode}"] = run
    return runs


def _assert_ranks_match(four_ranks, key: str, ref: dict) -> None:
    ranks, out = four_ranks
    for r in ranks:       # every rank reports the global loss
        got = r["runs"][key]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_RTOL)
        for k in ("mode", "devices", "mesh", "steps", "start_step", "end_step", "ok"):
            assert got[k] == ref[k], k
    with np.load(os.path.join(out, key.replace("/", "-") + ".npz")) as f:
        state = {k.replace("|", "/"): f[k] for k in f.files}
    assert_state_close(state, ref["state"], steps=STEPS)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("sizes", MESHES, ids=_spec)
def test_steps_match_jax_on_four_ranks(four_ranks, jax_runs, sizes, mode):
    key = f"{tuple(sizes)}/{mode}"
    _assert_ranks_match(four_ranks, key, jax_runs[key])


@pytest.mark.parametrize("sizes", LAYOUT_MESHES, ids=_spec)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_pjit_trains_every_layout_like_jax(four_ranks, layout, sizes):
    ref = jh.run_training(JaxMeshSpec.parse(_spec(sizes)).build(), steps=STEPS,
                          mode="pjit", rules=_jax_rules(LAYOUTS[layout]),
                          return_state=True)
    ref["state"] = _flat_host(ref["state"])
    _assert_ranks_match(four_ranks, f"{layout}/{tuple(sizes)}", ref)


def test_sweep_over_subset_meshes_matches_jax(four_ranks):
    ranks, _ = four_ranks
    ref = jh.run_sweep(devices=jax.devices()[:4], steps=2)
    reports = [r["sweep"] for r in ranks]
    # every rank ends with the same report, rank 0's rows
    for rep in reports[1:]:
        assert rep["rows"] == reports[0]["rows"]
    got = reports[0]
    assert sorted(got) == sorted(ref) and got["ok"] is True
    assert got["axes"] == ref["axes"] and got["devices"] == 4
    assert got["config"] == ref["config"]
    assert len(got["rows"]) == len(ref["rows"]) == 7
    for g, w in zip(got["rows"], ref["rows"]):
        assert set(g) == set(w) >= set(ph.ROW_SCHEMA)
        for k in ("axis", "devices", "mesh", "mode", "steps", "ok"):
            assert g[k] == w[k], k
        np.testing.assert_allclose(g["losses"], w["losses"], rtol=LOSS_RTOL)
    assert got["baseline"]["scaling_efficiency_pct"] == 100.0


def test_net_config_is_shared_with_the_validation_net():
    # the workload consumes the validation net's NetConfig, as the reference
    assert [f.name for f in dataclasses.fields(pv.NetConfig)] \
        == [f.name for f in dataclasses.fields(jv.NetConfig)]


def test_chip_smoke_holds_the_reference_losses():
    # the losses chip_smoke.py holds the card's runs to are the reference's
    import chip_smoke

    for spec, want in chip_smoke.WORKLOAD_LOSSES.items():
        ref = jh.run_training(JaxMeshSpec.parse(spec).build(), steps=len(want))
        assert ref["losses"] == want, spec


def test_adamw_overshoots_at_width_as_the_reference_does():
    # AdamW's first update moves every weight by lr = 0.01 (its sign step);
    # at width the loss jumps, in the reference as in the port (at
    # BENCH_CONFIG on the card it does not descend either, PERF.md). bf16
    # forward and update round at other points: the first two losses within
    # 1% of the reference's
    kw = dict(d_model=512, d_ff=4096, heads=8, b_local=2, s_local=128,
              dtype="bfloat16")
    ref = jh.run_training(JaxMeshSpec.parse("data=1,fsdp=1,tp=1").build(),
                          jv.NetConfig(**kw), steps=2)
    got = ph.run_training(_world_one(), pv.NetConfig(**kw), steps=2)
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-2)
    for run in (got, ref):
        assert run["losses"][1] > 10 * run["losses"][0]
        assert not run["descending"] and not run["ok"]
