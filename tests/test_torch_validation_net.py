"""The port's validation net against the JAX package's, on the host.

Host-side functions (`axis_sizes`, `analytic_train_flops`, `NetConfig`,
`param_specs`, `MeshSpec.parse`), the numpy host state bit for bit, and the
first training step — the loss and every updated parameter — at world 1
under each remat policy, then at 4 gloo ranks (one module-scoped spawn) on
meshes (1,1,2,2), (1,2,1,2), (2,2,1,1), (1,4,1,1) and (2,1,1,2), with a
3-step loss trajectory, against JAX on a virtual mesh of the same
MeshSpec.

Tolerances, and why:
- f32 loss: 1e-5 relative. Both sides do the same f32 arithmetic in other
  summation orders (they agree to ~2e-7).
- f32 parameters after a step: 1e-7 absolute, about 7 f32 steps at the
  parameters' magnitude (0.05-0.25); the step moves them by 1e-4 to 1e-3,
  so a gradient that is wrong or missing a rank's contribution fails.
- bf16: products and the update round to bf16 (relative step 2^-8): both
  losses of two steps within 2e-4 relative, parameters within 2^-11 +
  2^-7 relative (two bf16 steps). At the default lr 0.1 most updates are
  below one bf16 step, so the bf16 case runs at lr 4, where they are 5-66
  steps: each parameter's update within 0.1 of the reference's in norm
  (they agree to 0.006-0.027; a half-batch gradient is 0.66 off, a zero
  one 1.0).
"""

import dataclasses
import os
from types import SimpleNamespace

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from kubeoperator_tpu.parallel import validation_net as jv
from kubeoperator_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from kubeoperator_tpu.utils.errors import TopologyError as JaxTopologyError
from kubeoperator_tpu_torch.parallel import validation_net as pv
from kubeoperator_tpu_torch.parallel.mesh import MeshSpec
from kubeoperator_tpu_torch.parallel.multislice import initialize_from_env
from kubeoperator_tpu_torch.utils.errors import TopologyError
from kubeoperator_tpu_torch.weights import bf16_from_f64, from_jax_host

from tests.test_torch_ops import spawn_ranks

LOSS_RTOL_F32, PARAM_ATOL_F32 = 1e-5, 1e-7
LOSS_RTOL_BF16, PARAM_RTOL_BF16, PARAM_ATOL_BF16 = 2e-4, 2 ** -7, 2 ** -11
BF16_LR, UPDATE_RTOL_BF16 = 4.0, 0.1
WORLD_ONE = (1, 1, 1, 1)
# (name, (dp, pp, sp, tp), b_local, remat policies, steps): every axis is
# above 1 somewhere; pp4 is the one ring where sending left differs from
# sending right; dp_tp is the invariance case (global batch 4, as at world
# 1 with b_local 4)
CASES = [
    ("tp_sp", (1, 1, 2, 2), 2, ("full", "dots", "none"), 3),
    ("tp_pp", (1, 2, 1, 2), 2, ("full",), 3),
    ("dp_pp", (2, 2, 1, 1), 2, ("full",), 3),
    ("pp4", (1, 4, 1, 1), 2, ("none",), 1),
    ("dp_tp", (2, 1, 1, 2), 2, ("none",), 1),
]


def _axes(sizes):
    return tuple(zip(pv.AXES, sizes))


def _jax_mesh(sizes):
    return JaxMeshSpec(axes=_axes(sizes)).build()


# ------------------------------------------------------- host-side parity ----
@pytest.mark.parametrize("n", range(1, 17))
def test_axis_sizes_match_reference(n):
    assert pv.axis_sizes(n) == jv.axis_sizes(n)
    assert pv.mesh_spec_for(n).describe() == jv.mesh_spec_for(n).describe()


@pytest.mark.parametrize("sizes", [WORLD_ONE, (1, 1, 2, 2), (1, 2, 2, 2),
                                   (2, 2, 2, 2), (3, 1, 2, 2)])
@pytest.mark.parametrize("cfg", ["default", "bench"])
def test_analytic_train_flops_match_reference(sizes, cfg):
    port_cfg, jax_cfg = ((pv.BENCH_CONFIG, jv.BENCH_CONFIG) if cfg == "bench"
                         else (pv.NetConfig(), jv.NetConfig()))
    shape = SimpleNamespace(shape=dict(_axes(sizes)))
    assert pv.analytic_train_flops(MeshSpec(axes=_axes(sizes)), port_cfg) \
        == jv.analytic_train_flops(shape, jax_cfg)


def test_bench_flops_per_step():
    # the single-card figure the phase-12 bound is computed from
    assert pv.analytic_train_flops(pv.mesh_spec_for(1), pv.BENCH_CONFIG) \
        == pytest.approx(1.064e14, rel=1e-3)


def test_net_config_fields_and_bench_config_match_reference():
    port = [(f.name, f.default) for f in dataclasses.fields(pv.NetConfig)]
    ref = [(f.name, f.default) for f in dataclasses.fields(jv.NetConfig)]
    assert port == ref
    assert dataclasses.asdict(pv.BENCH_CONFIG) == dataclasses.asdict(jv.BENCH_CONFIG)


@pytest.mark.parametrize("name", ["wqkv", "w_in", "w_out", "w_gate", "w_exp",
                                  "w_head"])
def test_param_specs_are_the_reference_placements(name):
    ref = jv.param_specs(_jax_mesh(WORLD_ONE))[name]
    assert pv.param_specs()[name] == tuple(ref)


@pytest.mark.parametrize("name, axes", [
    ("wqkv", ("dp", "sp")), ("w_in", ("dp", "sp")), ("w_out", ("dp", "sp")),
    ("w_gate", ("dp", "sp")), ("w_exp", ("dp",)), ("w_head", ("dp", "sp", "pp")),
])
def test_gradients_sum_over_the_replicated_data_axes(name, axes):
    assert pv.grad_sum_axes(pv.param_specs()[name]) == axes


# text, n_devices, axis_names: good and bad inputs, one table for both
MESH_SPEC_TABLE = [
    ("data=2,fsdp=2,tp=2", None, None),
    (" dp = 2 , tp=4 ", None, None),
    ("data=-1,tp=2", 8, None),
    ("data=1,fsdp=-1", 6, None),
    ("dp=2,pp=1,sp=2,tp=2", None, ("dp", "pp", "sp", "tp")),
    ("data=-1,tp=3", 8, None),
    ("data=-1,tp=-1", 8, None),
    ("data=-1", None, None),
    ("data=zero", None, None),
    ("data=0", None, None),
    ("data", None, None),
    ("data=2,data=4", None, None),
    ("dp=4", None, ("data", "fsdp", "tp")),
    ("", None, None),
    (",,", None, None),
]


@pytest.mark.parametrize("text, n_devices, names", MESH_SPEC_TABLE)
def test_mesh_spec_parse_matches_reference(text, n_devices, names):
    def outcome(cls, error):
        try:
            spec = cls.parse(text, axis_names=names, n_devices=n_devices)
        except error as e:
            return ("error", str(e))
        return ("ok", spec.axes, spec.describe(), str(spec), spec.total_devices,
                spec.axis_names, spec.axis_lengths)

    assert outcome(MeshSpec, TopologyError) \
        == outcome(JaxMeshSpec, JaxTopologyError)


@pytest.mark.parametrize("axes", [(), (("a", 2), ("a", 2)), (("a", 0),),
                                  (("a", 1.5),)], ids=str)
def test_mesh_spec_rejects_what_the_reference_rejects(axes):
    with pytest.raises(TopologyError) as port:
        MeshSpec(axes=axes)
    with pytest.raises(JaxTopologyError) as ref:
        JaxMeshSpec(axes=axes)
    assert str(port.value) == str(ref.value)


# ------------------------------------------------------------- host state ----
def test_bf16_rounding_is_ml_dtypes_bit_for_bit():
    rng = np.random.default_rng(0)
    draws = rng.standard_normal(200_000) * 0.05
    # values that round to a bf16 tie only after rounding to f32 first,
    # where rounding the float64 directly would break the tie the other way
    ties = np.array([1.0 + (2 * k + 1) * 2 ** -8 for k in range(64)])
    ties = np.concatenate([ties + 2 ** -40, ties - 2 ** -40, -ties - 2 ** -40])
    special = np.array([0.0, -0.0, np.inf, -np.inf, 3.4e38, -3.4e38, 1e-42,
                        65504.0, np.nan])
    for a in (draws, ties, special):
        got = bf16_from_f64(a).view(torch.int16).numpy().view(np.uint16)
        want = a.astype(ml_dtypes.bfloat16).view(np.uint16)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sizes", [WORLD_ONE, (1, 1, 2, 2), (2, 2, 1, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_host_state_is_the_reference_bit_for_bit(sizes, dtype):
    _, x_ref, host_ref = jv.build_params_and_batch(
        _jax_mesh(sizes), seed=3, cfg=jv.NetConfig(dtype=dtype))
    host, x = pv.host_params_and_batch(dict(_axes(sizes)), seed=3,
                                       cfg=pv.NetConfig(dtype=dtype))
    bits = np.uint16 if dtype == "bfloat16" else np.uint32
    as_bits = {"bfloat16": torch.int16, "float32": torch.int32}[dtype]
    assert list(host) == list(host_ref)
    for k, ref in list(host_ref.items()) + [("x", np.asarray(x_ref))]:
        got = host[k] if k != "x" else x
        assert got.dtype == {"bfloat16": torch.bfloat16,
                             "float32": torch.float32}[dtype], k
        np.testing.assert_array_equal(
            got.view(as_bits).numpy().view(bits), np.asarray(ref).view(bits),
            err_msg=k)


def test_rms_is_the_reference_in_bf16():
    # the reference squares in bf16 before averaging in f32; squaring in
    # f32 moves the bf16 factor on about 3% of these rows, the same formula
    # on none but the rare row whose f32 mean sums in another order
    import jax.numpy as jnp
    from jax import lax

    rng = np.random.default_rng(7)
    h = rng.standard_normal((4096, 64)).astype(np.float32)
    hb = jnp.asarray(h).astype(jnp.bfloat16)
    want = hb * lax.rsqrt(jnp.mean((hb * hb).astype(jnp.float32), axis=-1,
                                   keepdims=True) + 1e-6).astype(hb.dtype)
    got = pv.rms(torch.from_numpy(h).bfloat16())
    rows_off = (got.float().numpy() != np.asarray(want.astype(jnp.float32))).any(-1)
    assert rows_off.sum() <= 4


# ----------------------------------------------- the step at world one ----
def _jax_steps(sizes, b_local, remat, steps, dtype="float32", lr=0.1):
    """(losses, first-step params, host) of the reference on a virtual mesh."""
    mesh = _jax_mesh(sizes)
    cfg = jv.NetConfig(b_local=b_local, remat=remat, dtype=dtype, lr=lr)
    params, x, host = jv.build_params_and_batch(mesh, cfg=cfg)
    step = jv.make_train_step(mesh, cfg=cfg)
    losses = []
    for i in range(steps):
        loss, params = step(params, x)
        losses.append(float(loss))
        if i == 0:
            first = {k: np.asarray(v).astype(np.float32) for k, v in params.items()}
    return losses, first, {k: np.asarray(v).astype(np.float32)
                           for k, v in host.items()}


def _port_world_one(b_local=2, remat="full", dtype="float32", steps=1, lr=0.1):
    initialize_from_env("cpu")
    mesh = MeshSpec(axes=_axes(WORLD_ONE)).build("cpu")
    cfg = pv.NetConfig(b_local=b_local, remat=remat, dtype=dtype, lr=lr)
    params, x, host = pv.build_params_and_batch(mesh, cfg=cfg)
    step = pv.make_train_step(mesh, cfg=cfg)
    losses = []
    for i in range(steps):
        loss, params = step(params, x)
        losses.append(float(loss))
        if i == 0:
            first = {k: v.float().numpy() for k, v in params.items()}
    return losses, first, {k: v.float().numpy() for k, v in host.items()}


def _assert_step_matches(port, ref, loss_rtol, param_rtol, param_atol):
    (p_losses, p_first, p_host), (r_losses, r_first, r_host) = port, ref
    np.testing.assert_allclose(p_losses, r_losses, rtol=loss_rtol)
    for k in r_first:
        np.testing.assert_array_equal(p_host[k], r_host[k], err_msg=k)
        np.testing.assert_allclose(p_first[k], r_first[k], rtol=param_rtol,
                                   atol=param_atol, err_msg=k)
        if param_rtol == 0:
            # the update itself, not only the parameter it lands on
            np.testing.assert_allclose(p_host[k] - p_first[k],
                                       r_host[k] - r_first[k],
                                       atol=param_atol, err_msg=k)


@pytest.mark.parametrize("remat", ["full", "dots", "none"])
def test_first_step_matches_jax_at_world_one(remat):
    _assert_step_matches(_port_world_one(remat=remat, steps=2),
                         _jax_steps(WORLD_ONE, 2, remat, 2),
                         LOSS_RTOL_F32, 0, PARAM_ATOL_F32)


def test_bf16_step_matches_jax_at_world_one():
    port = _port_world_one(dtype="bfloat16", remat="none", steps=2, lr=BF16_LR)
    ref = _jax_steps(WORLD_ONE, 2, "none", 2, "bfloat16", lr=BF16_LR)
    _assert_step_matches(port, ref, LOSS_RTOL_BF16, PARAM_RTOL_BF16,
                         PARAM_ATOL_BF16)
    (losses, p_first, p_host), (_, r_first, r_host) = port, ref
    assert losses[1] < losses[0]
    for k in r_first:
        want, got = r_first[k] - r_host[k], p_first[k] - p_host[k]
        if k == "w_gate":
            # one expert at sp=1: the gate's softmax is constant, so its
            # gradient is exactly 0 on both sides
            assert not want.any() and not got.any()
            continue
        assert np.linalg.norm(got - want) \
            <= UPDATE_RTOL_BF16 * np.linalg.norm(want), k


def test_typo_remat_raises():
    initialize_from_env("cpu")
    mesh = MeshSpec(axes=_axes(WORLD_ONE)).build("cpu")
    with pytest.raises(ValueError, match="remat"):
        pv.make_train_step(mesh, cfg=pv.NetConfig(remat="Full"))


def _mm_calls_in_backward(remat):
    """aten::mm calls made while the gradient of one step is computed."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.mm.default:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    initialize_from_env("cpu")
    mesh = MeshSpec(axes=_axes(WORLD_ONE)).build("cpu")
    cfg = pv.NetConfig(remat=remat)
    params, x, _ = pv.build_params_and_batch(mesh, cfg=cfg)
    step = pv.make_train_step(mesh, cfg=cfg)
    real_grad = torch.autograd.grad

    def counted_grad(*args, **kwargs):
        with Count():
            return real_grad(*args, **kwargs)

    torch.autograd.grad = counted_grad
    try:
        step(params, x)
    finally:
        torch.autograd.grad = real_grad
    return Count.n


def test_dots_policy_saves_the_weight_products():
    # a stage has five products with a 2-D weight (qkv, FFN in and out,
    # gate, expert): full remat computes them again in backward, dots
    # saves them like no remat at all
    full, dots, none = (_mm_calls_in_backward(r) for r in ("full", "dots", "none"))
    assert full - none == 5
    assert dots == none


# ---------------------------------------------------- 4 gloo ranks ----
_RANK_SCRIPT = """
import json, os, numpy as np, torch, torch.distributed as dist
from kubeoperator_tpu_torch.parallel import validation_net as vnet
from kubeoperator_tpu_torch.parallel.mesh import MeshSpec
from kubeoperator_tpu_torch.parallel.multislice import initialize_from_env
from kubeoperator_tpu_torch.weights import from_jax_host
initialize_from_env("cpu")
rank = dist.get_rank()
res = {{"rank": rank}}
for name, sizes, b_local, remats, steps in {cases}:
    mesh = MeshSpec(axes=tuple(zip(vnet.AXES, sizes))).build("cpu")
    coords = {{a: mesh.get_local_rank(a) for a in vnet.AXES}}
    for remat in remats:
        cfg = vnet.NetConfig(b_local=b_local, remat=remat)
        params, x, host = vnet.build_params_and_batch(mesh, cfg=cfg)
        placed = from_jax_host({{k: v.numpy() for k, v in host.items()}},
                               "cpu", mesh, vnet.param_specs())
        same = all(torch.equal(placed[k], params[k]) for k in params)
        step = vnet.make_train_step(mesh, cfg=cfg)
        losses = []
        for i in range(steps):
            loss, params = step(params, x)
            losses.append(float(loss))
            if i == 0:
                np.savez(os.path.join({out!r}, f"{{name}}-{{remat}}-{{rank}}.npz"),
                         **{{k: v.numpy() for k, v in params.items()}})
        res[f"{{name}}/{{remat}}"] = {{"losses": losses, "coords": coords,
                                     "from_jax_host": same}}
dist.barrier()
print("RANK_RESULT " + json.dumps(res), flush=True)
os._exit(0)
"""


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """(rank results, shard dir) of every CASES run at 4 gloo ranks."""
    out = tmp_path_factory.mktemp("vnet_shards")
    return spawn_ranks(4, _RANK_SCRIPT.format(cases=CASES, out=str(out))), out


def _gathered(four_ranks, name, remat):
    """The global first-step parameters, reassembled from every rank's
    shards; replicas of one block must agree bit for bit."""
    ranks, out = four_ranks
    full = {}
    for k, spec in pv.param_specs().items():
        blocks = {}
        for r in ranks:
            shard = np.load(os.path.join(out, f"{name}-{remat}-{r['rank']}.npz"))[k]
            coords = r[f"{name}/{remat}"]["coords"]
            key = tuple(coords[a] for a in spec if a is not None)
            if key in blocks:
                np.testing.assert_array_equal(shard, blocks[key][1],
                                              err_msg=f"{name} {k} replicas")
            blocks[key] = (coords, shard)
        full[k] = _assemble(list(blocks.values()), spec)
    return full


def _assemble(blocks, spec):
    """One global array from (coords, shard) blocks cut by `spec`."""
    shape = list(blocks[0][1].shape)
    for dim, axis in enumerate(spec):
        if axis is not None:
            shape[dim] *= 1 + max(c[axis] for c, _ in blocks)
    out = np.full(shape, np.nan, np.float32)
    for coords, shard in blocks:
        idx = tuple(slice(None) if axis is None else
                    slice(coords[axis] * shard.shape[dim],
                          (coords[axis] + 1) * shard.shape[dim])
                    for dim, axis in enumerate(spec))
        out[idx] = shard
    assert not np.isnan(out).any()
    return out


@pytest.fixture(scope="module")
def jax_runs():
    """Reference (losses, first-step params, host) per CASES run."""
    return {f"{name}/{remat}": _jax_steps(sizes, b_local, remat, steps)
            for name, sizes, b_local, remats, steps in CASES
            for remat in remats}


RUNS = [(name, remat) for name, _, _, remats, _ in CASES for remat in remats]


@pytest.mark.parametrize("name, remat", RUNS)
def test_steps_match_jax_on_four_ranks(four_ranks, jax_runs, name, remat):
    ranks, _ = four_ranks
    ref_losses, ref_first, ref_host = jax_runs[f"{name}/{remat}"]
    for r in ranks:   # every rank reports the same global loss
        np.testing.assert_allclose(r[f"{name}/{remat}"]["losses"], ref_losses,
                                   rtol=LOSS_RTOL_F32)
    got = _gathered(four_ranks, name, remat)
    for k, ref in ref_first.items():
        np.testing.assert_allclose(got[k], ref, rtol=0, atol=PARAM_ATOL_F32,
                                   err_msg=k)
        np.testing.assert_allclose(ref_host[k] - got[k], ref_host[k] - ref,
                                   rtol=0, atol=PARAM_ATOL_F32, err_msg=k)


def test_from_jax_host_places_each_ranks_shards(four_ranks):
    # every rank's cut of the global host state is the shard the step starts
    # from, on every mesh
    ranks, _ = four_ranks
    for name, remat in RUNS:
        assert all(r[f"{name}/{remat}"]["from_jax_host"] for r in ranks), name


def test_from_jax_host_reads_the_reference_bf16_host_state():
    # the reference's host dict (ml_dtypes bfloat16) placed on a mesh is the
    # port's own parameters, bit for bit
    initialize_from_env("cpu")
    mesh = MeshSpec(axes=_axes(WORLD_ONE)).build("cpu")
    _, _, host = jv.build_params_and_batch(
        _jax_mesh(WORLD_ONE), cfg=jv.NetConfig(dtype="bfloat16"))
    params, _, _ = pv.build_params_and_batch(
        mesh, cfg=pv.NetConfig(dtype="bfloat16"))
    placed = from_jax_host(host, "cpu", mesh, pv.param_specs())
    assert list(placed) == list(params)
    for k, v in params.items():
        assert v.dtype == torch.bfloat16 and torch.equal(placed[k], v), k


def test_remat_policies_agree_on_four_ranks(four_ranks):
    ranks, _ = four_ranks
    for r in ranks:
        full = r["tp_sp/full"]["losses"]
        assert r["tp_sp/dots"]["losses"] == pytest.approx(full, rel=1e-6)
        assert r["tp_sp/none"]["losses"] == pytest.approx(full, rel=1e-6)
        assert full[-1] < full[0]


def test_the_update_is_invariant_under_dp_and_tp(four_ranks):
    # (dp=2, tp=2, b_local=2) on 4 ranks takes the same step as
    # (dp=1, b_local=4) at world 1: the same global batch, the same
    # full-batch gradient
    single = _port_world_one(b_local=4, remat="none")
    _, ref_first, ref_host = single
    got = _gathered(four_ranks, "dp_tp", "none")
    ranks, _ = four_ranks
    np.testing.assert_allclose(ranks[0]["dp_tp/none"]["losses"], single[0],
                               rtol=LOSS_RTOL_F32)
    for k, ref in ref_first.items():
        np.testing.assert_allclose(got[k], ref, rtol=0, atol=PARAM_ATOL_F32,
                                   err_msg=k)
