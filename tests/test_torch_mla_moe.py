"""The Kimi-K2 block of the tenant workload (`workloads/mla_moe.py`) against
its plain reference (`workloads/mla_moe_reference.py`) on the host.

At a small size in float32 both compute the same function, so logits,
loss, every gradient and three AdamW steps through the training entry
agree to float32 rounding. The expert layer's share is tied to the whole
layer, the router's choices and weights to DeepSeek-V3's gate, YaRN's
frequencies and the softmax scale to their closed forms, and the slot
counter to the selection. Imports no JAX.
"""

import dataclasses
import inspect
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from kubeoperator_tpu_torch.parallel.mesh import MeshSpec
from kubeoperator_tpu_torch.parallel.multislice import initialize_from_env
from kubeoperator_tpu_torch.parallel.validation_net import NetConfig
from kubeoperator_tpu_torch.utils import spans
from kubeoperator_tpu_torch.utils.errors import ValidationError
from kubeoperator_tpu_torch.workloads import dense, harness, mla_moe, serve, step
from kubeoperator_tpu_torch.workloads import mla_moe_reference as ref
from kubeoperator_tpu_torch.workloads.mla_moe import MlaMoeConfig
from kubeoperator_tpu_torch.workloads.partition import match_partition_rules

SMALL = MlaMoeConfig(
    hidden=64, heads=4, q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
    qk_rope_head_dim=8, v_head_dim=16, intermediate=96, moe_intermediate=24,
    n_routed_experts=16, experts_per_token=4, n_shared_experts=1,
    experts_held=(0, 1, 2, 3), vocab_held=64, n_dense_layers=1,
    n_moe_layers=2, b_local=2, s_local=16, dtype="float32", init_scale=0.1,
    lr=1e-3)
SEED = 2 ** 31 + 17
# f32 on both sides: the same sums in other orders (heads in blocks, the
# experts' rows gathered, F.rms_norm's fused statistics) leave errors of a
# few f32 steps (2^-23 ≈ 1.2e-7) of each entry, summed over at most a few
# hundred terms; 1e-5 of a tensor's norm is a hundredfold margin, and a
# wrong mask, rotation, weight or expert is off by the order of the tensor
F32_TOL = 1e-5


def _mesh():
    initialize_from_env("cpu")
    return MeshSpec.parse("data=1,fsdp=1,tp=1").build("cpu")


def _params(cfg=SMALL, seed=SEED):
    return mla_moe.init_params(cfg, seed, "cpu")


def _batch(cfg=SMALL, seed=SEED + 1):
    return mla_moe.host_batch(cfg, cfg.b_local, seed)


def _rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def _trainable(cfg):
    return [k for k in mla_moe.param_shapes(cfg)
            if k not in mla_moe.frozen(cfg)]


def test_logits_loss_and_every_gradient_match_the_reference():
    ref.no_tf32()
    p, batch = _params(), _batch()
    names = _trainable(SMALL)
    leaves = {k: v.clone().requires_grad_(k in names) for k, v in p.items()}
    logits = mla_moe.forward(leaves, batch[:, :-1], SMALL)
    want = ref.logits(p, batch[:, :-1], SMALL, ref.mm_f32)
    assert _rel(logits.detach(), want) < F32_TOL
    denom = batch.shape[0] * SMALL.s_local
    loss = mla_moe.loss_sum(leaves, batch, SMALL) / denom
    got = torch.autograd.grad(loss, [leaves[k] for k in names])
    rleaves = {k: v.clone().requires_grad_(k in names) for k, v in p.items()}
    rloss = ref.loss_sum(rleaves, batch, SMALL, ref.mm_f32) / denom
    wanted = torch.autograd.grad(rloss, [rleaves[k] for k in names])
    assert abs(float(loss.detach()) - float(rloss.detach())) \
        < F32_TOL * float(rloss.detach())
    for k, g, w in zip(names, got, wanted):
        assert _rel(g, w) < F32_TOL, k


def test_three_adamw_steps_through_the_training_entry_match_the_reference():
    mesh = _mesh()
    run = harness.run_training(mesh, SMALL, steps=3, seed=SEED,
                               return_state=True)
    assert run["mode"] == "pjit" and run["steps"] == 3
    p0 = _params()
    want = ref.adamw_steps(p0, _batch(), SMALL, 3,
                           frozen=mla_moe.frozen(SMALL))
    # the losses to f32 rounding; the change of each leaf in norm: AdamW's
    # first steps are near sign steps of lr, so an entry whose gradient is
    # a rounding error from zero may step either way, a few entries of the
    # thousands in a leaf
    assert np.allclose(run["losses"], want["losses"], rtol=1e-5)
    got = run["state"]["params"]
    for k in _trainable(SMALL):
        change = got[k].double() - p0[k].double()
        assert _rel(change, want["params"][k] - p0[k].double()) < 1e-3, k
    for k in mla_moe.frozen(SMALL):
        if k != "step":
            assert torch.equal(got[k], p0[k]), k
    assert float(got["step"]) == 3.0


def test_the_expert_shares_add_up_to_the_uncut_layer():
    """Four cards of four experts each: their routed parts, with the shared
    expert counted once, are the whole layer of all sixteen."""
    ref.no_tf32()
    whole = dataclasses.replace(SMALL, experts_held=tuple(range(16)))
    p = _params(whole)
    pre = mla_moe.layer_prefix(1)
    x = torch.randn((40, SMALL.hidden), generator=torch.Generator().manual_seed(5))
    parts = []
    for share in range(4):
        held = tuple(range(4 * share, 4 * share + 4))
        cut = dataclasses.replace(SMALL, experts_held=held)
        mine = dict(p)
        for leaf in ("experts_gate", "experts_up", "experts_down"):
            mine[pre + leaf] = p[pre + leaf][list(held)]
        parts.append(mla_moe.experts(x, mla_moe.dispatch(x, mine, pre, cut, 1),
                                     mine, pre, cut))
    got = sum(parts) + mla_moe.shared(x, p, pre)
    want = ref.ffn(x[None], p, 1, whole, ref.mm_f32)[0]
    assert _rel(got, want) < F32_TOL


def test_routing_selects_on_biased_scores_and_weights_on_the_scores():
    cfg = dataclasses.replace(SMALL, experts_per_token=2, n_routed_experts=4,
                              routed_scaling_factor=2.827)
    # one token; router rows give logits 0, 1, 2, 3
    x = torch.tensor([[1.0] + [0.0] * 63])
    router = torch.zeros((4, 64))
    router[:, 0] = torch.tensor([0.0, 1.0, 2.0, 3.0])
    s = torch.sigmoid(torch.tensor([0.0, 1.0, 2.0, 3.0]))
    # the bias lifts experts 0 and 1 above 2 and 3 for the choice alone
    b_corr = torch.tensor([10.0, 10.0, 0.0, 0.0])
    idx, w = mla_moe.route(x, router, b_corr, cfg)
    assert sorted(idx[0].tolist()) == [0, 1]
    pick = s[idx[0]]
    assert torch.allclose(w[0], 2.827 * pick / pick.sum())
    assert math.isclose(float(w.sum()), 2.827, rel_tol=1e-6)
    # no capacity: every token keeps all k choices, and every held choice
    # reaches an expert
    p = _params()
    pre = mla_moe.layer_prefix(1)
    xs = torch.randn((64, SMALL.hidden), generator=torch.Generator().manual_seed(8))
    idx, _ = mla_moe.route(xs, p[pre + "router"], p[pre + "b_corr"], SMALL)
    assert idx.shape == (64, SMALL.experts_per_token)
    assert all(len(set(row)) == SMALL.experts_per_token for row in idx.tolist())
    mla_moe.expert_loads.reset()
    mla_moe.experts(xs, mla_moe.dispatch(xs, p, pre, SMALL, 1), p, pre, SMALL)
    held = torch.isin(idx, torch.tensor(SMALL.experts_held)).sum()
    assert int(mla_moe.expert_loads.read().sum()) == int(held)


@pytest.mark.parametrize("cfg", [MlaMoeConfig(), SMALL], ids=["published", "small"])
def test_yarn_frequencies_and_softmax_scale_are_the_closed_forms(cfg):
    d = cfg.qk_rope_head_dim
    i = np.arange(d // 2)
    base = cfg.rope_theta ** (-2 * i / d)
    if cfg == MlaMoeConfig():
        # the ramp of yarn_find_correction_range(1, 1, 64, 50000, 4096) is
        # [19, 20]: pairs up to 19 keep base^(-2i/64), from 20 on /32
        closed = np.where(i <= 19, base, base / 32)
        assert math.isclose(mla_moe.softmax_scale(cfg),
                            192 ** -0.5 * (0.1 * math.log(32) + 1) ** 2,
                            rel_tol=1e-12)
        assert math.isclose(mla_moe.softmax_scale(cfg), 0.130861, rel_tol=1e-5)
    else:
        low, high = ref.yarn_find_correction_range(1, 1, d, cfg.rope_theta,
                                                   cfg.rope_original_max_position)
        ramp = np.clip((i - low) / max(high - low, 1e-3), 0, 1)
        closed = base / cfg.rope_factor * ramp + base * (1 - ramp)
    # f32 powers of the base: a few f32 steps
    assert np.allclose(mla_moe.rope_frequencies(cfg).numpy(), closed,
                       rtol=1e-6, atol=0)
    assert np.allclose(ref.inv_frequencies(cfg).numpy(), closed, rtol=1e-6,
                       atol=0)
    assert mla_moe.softmax_scale(cfg) == pytest.approx(ref.softmax_scale(cfg))


def test_the_slot_counter_is_a_bincount_of_the_selection():
    p, batch = _params(), _batch()
    mla_moe.expert_loads.reset()
    with torch.no_grad():
        mla_moe.forward(p, batch[:, :-1], SMALL)
        loads = mla_moe.expert_loads.read()
        # the selection again, from the same layer inputs
        x = torch.nn.functional.embedding(batch[:, :-1], p["embed"])
        rope = mla_moe.rope_tables(SMALL, SMALL.s_local, "cpu")
        want = []
        for i in range(SMALL.n_layers):
            pre = mla_moe.layer_prefix(i)
            x = x + mla_moe.mla(mla_moe.rms_norm(x, p[pre + "attn_norm"], 1e-6),
                                p, pre, SMALL, rope)
            h = mla_moe.rms_norm(x, p[pre + "ffn_norm"], 1e-6)
            if i >= SMALL.n_dense_layers:
                idx, _ = mla_moe.route(h.reshape(-1, SMALL.hidden),
                                       p[pre + "router"], p[pre + "b_corr"],
                                       SMALL)
                want.append(torch.bincount(idx.flatten(), minlength=16)[:4])
            x = x + mla_moe.ffn(h, p, i, SMALL)
    assert loads.dtype == torch.int64
    assert torch.equal(loads, torch.stack(want))


def test_the_configured_lr_moves_the_weights_by_that_lr():
    """The configuration's AdamW lr reaches the training entry's step:
    AdamW's first step is lr · g / (|g| + eps) (+ lr · decay · p), so each
    entry with a gradient far above eps moves by lr, within the decay's
    1e-4 of the weight."""
    mesh = _mesh()
    cfg = dataclasses.replace(SMALL, lr=3e-3)
    run = harness.run_training(mesh, cfg, steps=1, seed=SEED,
                               return_state=True)
    p0 = step.init_train_state(mesh, cfg, seed=SEED)["params"]
    moved = torch.cat([(run["state"]["params"][k] - p0[k]).abs().flatten()
                       for k in p0 if k not in step.frozen_leaves(cfg)])
    assert float(moved.median()) == pytest.approx(cfg.lr, rel=1e-3)


def test_the_dense_stage_keeps_its_default_lr():
    assert step.adamw_lr(NetConfig()) == step.ADAMW_LR == 1e-2
    assert step.adamw_lr(SMALL) == SMALL.lr == mla_moe.adamw_lr(SMALL)
    assert dense.adamw_lr(NetConfig()) == step.make_optimizer().lr
    assert step.frozen_leaves(NetConfig()) == dense.frozen(NetConfig())
    assert step.frozen_leaves(SMALL) == mla_moe.frozen(SMALL)


def test_the_rules_cover_every_leaf_and_replicate_router_norms_and_biases():
    assert step.default_rules(SMALL) == mla_moe.default_rules()
    specs = match_partition_rules(step.default_rules(SMALL),
                                  step.train_state_shapes(SMALL))
    params = specs["params"]
    assert set(params) == set(mla_moe.param_shapes(SMALL))
    for name, spec in params.items():
        if name == "step":
            assert spec == ()
        elif name.endswith(("router", "norm", "b_corr")):
            assert all(a is None for a in spec), name
        else:
            assert spec == ("fsdp", None), name
    assert specs["opt"][0].mu == params


def test_the_step_build_refuses_latent_widths_the_kernels_lack():
    cuda = type("Mesh", (), {"device_type": "cuda"})()
    published = dataclasses.replace(SMALL, dtype="bfloat16",
                                    qk_nope_head_dim=128,
                                    qk_rope_head_dim=64, v_head_dim=128)
    step.check_attention_width(cuda, published)
    assert mla_moe.attention_unbuilt(published) is None
    assert "latent attention" in mla_moe.attention_unbuilt(SMALL)
    with pytest.raises(ValidationError, match="latent attention"):
        step.check_attention_width(cuda, dataclasses.replace(SMALL,
                                                             dtype="bfloat16"))
    step.check_attention_width(cuda, SMALL)            # f32: the plain chain


# the seam every model module exports: each function's parameters
SEAM = {
    "param_shapes": ("cfg",),
    "init_params": ("cfg", "seed", "device"),
    "host_batch": ("cfg", "rows", "seed"),
    "forward": ("p", "x", "cfg", "tp"),
    "loss_sum": ("p", "batch", "cfg", "tp"),
    "loss_count": ("cfg", "rows"),
    "step_flops": ("cfg", "tokens"),
    "default_rules": (),
    "frozen": ("cfg",),
    "adamw_lr": ("cfg",),
    "attention_unbuilt": ("cfg",),
}


@pytest.mark.parametrize("kind", [*step.MODELS, None],
                         ids=lambda k: k.__name__ if k else "unknown")
def test_every_model_of_the_table_exports_the_seam(kind):
    if kind is None:
        with pytest.raises(ValidationError, match="no model for a"):
            step.model_of(SimpleNamespace(dtype="float32"))
        return
    model = step.model_of(kind())
    assert model is step.MODELS[kind]
    for name, params in SEAM.items():
        sig = inspect.signature(getattr(model, name))
        assert tuple(sig.parameters) == params, (model.__name__, name)
        if "tp" in params:
            assert sig.parameters["tp"].default is None


def test_the_serve_forward_returns_the_logits():
    mesh = _mesh()
    fn, specs, used = serve.make_forward(mesh, SMALL)
    assert used == "pjit" and set(specs) == set(mla_moe.param_shapes(SMALL))
    p, batch = _params(), _batch()
    got = fn(p, batch[:, :-1])
    assert got.shape == (SMALL.b_local, SMALL.s_local, SMALL.vocab_held)
    assert torch.equal(got, mla_moe.forward(p, batch[:, :-1], SMALL))


def test_a_profiled_step_nests_the_expert_spans_in_the_ffn():
    mesh = _mesh()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        harness.run_training(mesh, SMALL, steps=2, seed=SEED)
    ranges = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.is_user_annotation() and e.name().startswith("ko.")),
                    key=lambda r: r[1])
    counts = {n: sum(r[0] == n for r in ranges) for n in spans.SPANS}
    layers, moe = SMALL.n_layers, SMALL.n_moe_layers
    assert counts == {"ko.train.step": 2, "ko.block.attention": 2 * layers,
                      "ko.block.ffn": 2 * layers, "ko.step.optimizer": 2,
                      "ko.moe.route": 4 * moe, "ko.moe.experts": 2 * moe,
                      "ko.moe.combine": 2 * moe, "ko.moe.shared": 2 * moe,
                      "ko.model.head": 2}
    ffn = [r for r in ranges if r[0] == "ko.block.ffn"]
    for r in ranges:
        if r[0].startswith("ko.moe."):
            assert any(f[1] <= r[1] and r[2] <= f[2] for f in ffn), r
    steps = [r for r in ranges if r[0] == "ko.train.step"]
    for r in ranges:
        if r[0] == "ko.model.head":
            assert not any(b[0].startswith("ko.block.") and b[1] <= r[1] <= b[2]
                           for b in ranges)
            assert any(s[1] <= r[1] and r[2] <= s[2] for s in steps)
