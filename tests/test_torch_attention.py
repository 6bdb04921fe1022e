"""The dense stage's fused causal attention (`ops/attention.py`, K3).

On the host: the plain version is the chain `workloads/dense.py::forward`
ran before, bit for bit; a plain PyTorch walk of the kernels' tiles
matches autograd of the plain version in f32; both models send every
attention to the wrapper, which takes the plain version for f32 and for
CPU tensors and refuses what the kernels do not take. On a card (marker
``cuda``, skipped elsewhere): the kernels against the plain version there
at the cells' shapes, bit-identical gradients from run to run, and the
launches a dense forward makes. Imports no JAX:

    python -m pytest tests/test_torch_attention.py -m cuda --noconftest -q
"""

import dataclasses
import math
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from kubeoperator_tpu_torch.ops import attention
from kubeoperator_tpu_torch.ops.attention import (
    attention_reference,
    causal_attention,
)
from kubeoperator_tpu_torch.parallel.validation_net import NetConfig
from kubeoperator_tpu_torch.utils.errors import ValidationError
from kubeoperator_tpu_torch.workloads import dense, mla_moe, step
from kubeoperator_tpu_torch.workloads.mla_moe import MlaMoeConfig


def _qkv(bsz, seq, h, dh, dtype, seed=0, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn((bsz, seq, 3 * h * dh), generator=gen).to(dtype)
    return qkv.to(device).requires_grad_()


def _heads(qkv, h):
    bsz, seq, three_d = qkv.shape
    d = three_d // 3
    return [t.reshape(bsz, seq, h, d // h)
            for t in torch.split(qkv, d, dim=-1)]


def former_chain(qkv, h):
    """The dense forward's attention as the step wrote it before the
    kernel."""
    bsz, seq, three_d = qkv.shape
    d = three_d // 3
    dh = d // h
    q, k, v = torch.split(qkv, d, dim=-1)

    def heads4(t):
        return t.reshape(bsz, seq, h, dh)

    root = torch.full((), math.sqrt(dh), dtype=torch.float32,
                      device=qkv.device)
    logits = torch.einsum("bqhe,bkhe->bhqk", heads4(q),
                          heads4(k)).float() / root
    causal = torch.ones((seq, seq), dtype=torch.bool,
                        device=qkv.device).tril()
    logits = torch.where(causal, logits, -1e30)
    attn = torch.softmax(logits, dim=-1).to(qkv.dtype)
    return torch.einsum("bhqk,bkhe->bqhe", attn,
                        heads4(v)).reshape(bsz, seq, d)


def _grads(fn, qkv, h, seed=1):
    out = fn(qkv, h)
    gen = torch.Generator().manual_seed(seed)
    dout = torch.randn(out.shape, generator=gen).to(out.dtype).to(out.device)
    (grad,) = torch.autograd.grad(out, qkv, dout)
    return out.detach(), grad


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 17, 2, 8), (1, 40, 2, 64)])
def test_plain_version_is_the_former_chain_bit_for_bit(dtype, shape):
    bsz, seq, h, dh = shape
    qkv = _qkv(bsz, seq, h, dh, dtype)
    want_out, want_grad = _grads(former_chain, qkv, h)
    got_out, got_grad = _grads(
        lambda t, heads: causal_attention(*_heads(t, heads)), qkv, h)
    assert torch.equal(got_out, want_out)
    assert torch.equal(got_grad, want_grad)


def _parts(r0, held, parts, seq):
    """The row groups of the held tile at `r0` (`parts` of held // parts
    rows, cut at seq) as (first row, rows)."""
    sub = held // parts
    return [(c0, torch.arange(c0, min(c0 + sub, seq)))
            for c0 in range(r0, r0 + held, sub) if c0 < seq]


def tiled_attention(q, k, v, do, held, streamed, scale=None, kv_walk=None,
                    q_walk=None, fwd_walk=None):
    """The kernels' walks in plain f32 PyTorch, for [b, s, h, dh] inputs
    (v and dO may be narrower; `scale` in place of 1/sqrt(dh)):
    forward per `held`-row Q tile over `streamed`-row K/V tiles, skipping
    those wholly above the diagonal and masking only the tiles the diagonal
    crosses, with an online max and sum; the log-sum-exp; D = rowsum(dO∘O);
    dK and dV in one walk per held K tile over Q tiles from the diagonal
    down, P and dS formed once for both; dQ per held Q tile over K tiles up
    to it. `fwd_walk`, `kv_walk` and `q_walk`, where given, are those walks'
    own (held rows, streamed rows, parts): each held tile is cut into
    `parts` row groups (the pair's consumer warpgroups) that skip the
    streamed tiles wholly masked for them, and a forward part wholly past s
    all of them. Returns (o [b, s, h·dh], dq, dk, dv, the forward's skipped
    streamed tiles per part)."""
    bsz, seq, h, dh = q.shape
    dv_w = v.shape[3]
    root = torch.tensor(math.sqrt(dh)) if scale is None else 1 / torch.tensor(scale)
    qh, kh, vh, doh = (t.transpose(1, 2) for t in (q, k, v, do))
    o = torch.zeros_like(vh)
    lse = torch.zeros(qh.shape[:3])

    def scores(rows, cols, diagonal):
        s = qh[:, :, rows] @ kh[:, :, cols].transpose(-1, -2) / root
        seen = cols[None, :] <= rows[:, None]
        if not diagonal:                # the kernels leave these unmasked
            assert bool(seen.all())
            return s
        return torch.where(seen, s, attention.MASK)

    fwd_held, fwd_streamed, fwd_parts = fwd_walk or (held, streamed, 1)
    sub = fwd_held // fwd_parts
    skipped = [0] * fwd_parts
    for m0 in range(0, seq, fwd_held):
        for part, c0 in enumerate(range(m0, m0 + fwd_held, sub)):
            rows = torch.arange(min(c0, seq), min(c0 + sub, seq))
            m_i = torch.full(qh.shape[:2] + (len(rows),), -math.inf)
            l_i = torch.zeros_like(m_i)
            acc = torch.zeros(qh.shape[:2] + (len(rows), dv_w))
            for n0 in range(0, seq, fwd_streamed):
                cols = torch.arange(n0, min(n0 + fwd_streamed, seq))
                if c0 >= seq or n0 >= c0 + sub:  # past s, or above the diagonal
                    assert bool((cols[:, None] > rows[None, :]).all())
                    skipped[part] += 1
                    continue
                s = scores(rows, cols, n0 + fwd_streamed > c0)
                m_new = torch.maximum(m_i, s.amax(-1))
                p = torch.exp(s - m_new[..., None])
                alpha = torch.exp(m_i - m_new)
                l_i = l_i * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + p @ vh[:, :, cols]
                m_i = m_new
            o[:, :, rows] = acc / l_i[..., None]
            lse[:, :, rows] = m_i + torch.log(l_i)
    delta = (doh * o).sum(-1)
    dq, dk, dv = torch.zeros_like(qh), torch.zeros_like(kh), torch.zeros_like(vh)
    kv_held, kv_streamed, kv_parts = kv_walk or (held, streamed, 1)
    for n0 in range(0, seq, kv_held):
        for c0, cols in _parts(n0, kv_held, kv_parts, seq):
            sub = kv_held // kv_parts
            for m0 in range(n0, seq, kv_streamed):
                rows = torch.arange(m0, min(m0 + kv_streamed, seq))
                if m0 + kv_streamed <= c0:      # wholly above the diagonal
                    assert bool((rows[:, None] < cols[None, :]).all())
                    continue
                p = torch.exp(scores(rows, cols, m0 < c0 + sub)
                              - lse[:, :, rows, None])
                dp = doh[:, :, rows] @ vh[:, :, cols].transpose(-1, -2)
                ds = p * (dp - delta[:, :, rows, None]) / root
                dv[:, :, cols] += p.transpose(-1, -2) @ doh[:, :, rows]
                dk[:, :, cols] += ds.transpose(-1, -2) @ qh[:, :, rows]
    q_held, q_streamed, q_parts = q_walk or (held, streamed, 1)
    for m0 in range(0, seq, q_held):
        for c0, rows in _parts(m0, q_held, q_parts, seq):
            sub = q_held // q_parts
            for n0 in range(0, min(m0 + q_held, seq), q_streamed):
                cols = torch.arange(n0, min(n0 + q_streamed, seq))
                if n0 >= c0 + sub:              # wholly above the diagonal
                    assert bool((cols[None, :] > rows[:, None]).all())
                    continue
                p = torch.exp(scores(rows, cols, n0 + q_streamed > c0)
                              - lse[:, :, rows, None])
                dp = doh[:, :, rows] @ vh[:, :, cols].transpose(-1, -2)
                ds = p * (dp - delta[:, :, rows, None]) / root
                dq[:, :, rows] += ds @ kh[:, :, cols]
    return (o.transpose(1, 2).reshape(bsz, seq, h * dv_w),
            *(t.transpose(1, 2) for t in (dq, dk, dv)), skipped)


@pytest.mark.parametrize("seq,dh,held,streamed", [
    (37, 64, 16, 8),      # s not a multiple of either tile
    (48, 64, 16, 16),     # square tiles: the diagonal on tile edges
    (40, 512, 16, 4),     # the cells' head width, thin streamed tiles
    (29, 512, 8, 8),
    (100, 64, 64, 32),    # the kernels' own tiles: 64 rows held, 32 streamed
])
def test_tile_walk_matches_autograd_of_the_plain_version(seq, dh, held,
                                                         streamed):
    qkv = _qkv(2, seq, 2, dh, torch.float32, seed=seq)
    q, k, v = _heads(qkv, 2)
    out = attention_reference(q, k, v)
    do = torch.randn(out.shape, generator=torch.Generator().manual_seed(7))
    want = (out, *torch.autograd.grad(out, (q, k, v), do))
    *got, skipped = tiled_attention(q.detach(), k.detach(), v.detach(),
                                    do.reshape(q.shape), held, streamed)
    n_tiles = -(-seq // streamed)
    assert skipped == [sum(max(0, n_tiles - -(-min(m0 + held, seq) // streamed))
                           for m0 in range(0, seq, held))]
    assert skipped[0] > 0
    # the same f32 arithmetic summed in another order (tiles, the online
    # rescaling, D for rowsum(dP∘P)): a few f32 steps of entries up to ~10
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w.detach(), rtol=1e-5, atol=1e-5)


# the pair's kernels' tiles: `held` as (held rows, parts), `streamed` as
# (forward, dK·dV walk, dQ walk)
PAIR_HELD, PAIR_STREAMED = (128, 2), (64, 64, 64)


def forward_skips(seq, held, streamed, parts):
    """The streamed tiles each part of the forward's held tiles skips: those
    from the one past its last row (its rows' diagonal, or s) to the last,
    and all of them for a part wholly past s."""
    n_tiles, sub = -(-seq // streamed), held // parts
    return [sum(n_tiles - (-(-min(c0 + sub, seq) // streamed) if c0 < seq else 0)
                for c0 in range(part * sub, -(-seq // held) * held, held))
            for part in range(parts)]


@pytest.mark.parametrize("seq,held,streamed", [
    (37, 16, 8), (100, 64, 32),
    # the pair's kernels' own tiles: s cut raggedly, one held tile, a
    # second warpgroup past s, rows on tile edges
    pytest.param(129, PAIR_HELD, PAIR_STREAMED, id="pair-129"),
    pytest.param(64, PAIR_HELD, PAIR_STREAMED, id="pair-64"),
    pytest.param(200, PAIR_HELD, PAIR_STREAMED, id="pair-200"),
    pytest.param(256, PAIR_HELD, PAIR_STREAMED, id="pair-256"),
    # the same walks at thin tiles: many skipped and crossed tiles
    pytest.param(37, (16, 2), (8, 4, 8), id="pair-thin-37"),
])
def test_tile_walk_at_latent_widths_matches_autograd_of_the_plain_version(
        seq, held, streamed):
    """q and k 192 wide, v 128 (a view of a wider kv product), scores
    times the softmax scale: the walks with the widths apart; at the pair's
    tiles, the forward walk, the fused dK·dV walk and the dQ walk over 128
    held rows as two warpgroups' 64, each skipping the streamed tiles
    wholly masked for its own rows."""
    walks = {}
    if isinstance(held, tuple):
        (held, parts), (streamed, kv_streamed, q_streamed) = held, streamed
        walks = dict(fwd_walk=(held, streamed, parts),
                     kv_walk=(held, kv_streamed, parts),
                     q_walk=(held, q_streamed, parts))
    gen = torch.Generator().manual_seed(seq)
    q, k = (torch.randn((2, seq, 2, 192), generator=gen).requires_grad_()
            for _ in range(2))
    kv = torch.randn((2, seq, 2, 256), generator=gen).requires_grad_()
    v = kv[..., 128:]
    scale = 0.130861
    out = attention_reference(q, k, v, scale)
    assert out.shape == (2, seq, 2 * 128)
    do = torch.randn(out.shape, generator=torch.Generator().manual_seed(7))
    want = (out, *torch.autograd.grad(out, (q, k, v), do))
    *got, skipped = tiled_attention(q.detach(), k.detach(), v.detach(),
                                    do.reshape(2, seq, 2, 128), held, streamed,
                                    scale, **walks)
    parts = walks["fwd_walk"][2] if walks else 1
    assert skipped == forward_skips(seq, held, streamed, parts)
    # as the square walks above: the same f32 arithmetic in another order
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w.detach(), rtol=1e-5, atol=1e-5)


def test_plain_version_with_a_scale_multiplies_the_f32_logits():
    gen = torch.Generator().manual_seed(2)
    q, k = (torch.randn((1, 9, 2, 192), generator=gen).bfloat16() for _ in range(2))
    v = torch.randn((1, 9, 2, 128), generator=gen).bfloat16()
    logits = torch.einsum("bqhe,bkhe->bhqk", q, k).float() * torch.tensor(0.5)
    logits = torch.where(torch.ones(9, 9, dtype=torch.bool).tril(), logits,
                         attention.MASK)
    attn = torch.softmax(logits, dim=-1).bfloat16()
    want = torch.einsum("bhqk,bkhe->bqhe", attn, v).reshape(1, 9, 256)
    assert torch.equal(attention_reference(q, k, v, 0.5), want)
    assert torch.equal(causal_attention(q, k, v, 0.5), want)


def _kernel_quotient(x: np.ndarray, root: float, rinv: float) -> np.ndarray:
    """x / root as the kernels compute it, t = x·rinv then
    fma(fma(-t, root, x), rinv, t), each step rounded to f32 once: the
    products of two f32 are exact in f64, the residual x - t·root is too,
    and the last sum's f64 rounding error is recovered exactly (two-sum),
    so the f32 rounding of the exact sum is taken, ties included."""
    x = x.astype(np.float64)
    t = (x * rinv).astype(np.float32).astype(np.float64)
    r = (x - t * root).astype(np.float32).astype(np.float64)
    a, b = t, r * rinv
    hi = a + b
    bb = hi - a
    lo = (a - (hi - bb)) + (b - bb)
    f = hi.astype(np.float32)
    toward = np.where(hi > f, np.inf, -np.inf).astype(np.float32)
    other = np.nextafter(f, toward)
    tie = (hi != f) & (hi == (f.astype(np.float64) + other) / 2)
    away = tie & (np.sign(lo) == np.sign(other.astype(np.float64) - hi))
    return np.where(away, other, f)


@pytest.mark.parametrize("dh", (8, 16, 32, 64, 96, 128, 256, 512))
def test_the_kernels_divide_by_sqrt_dh_as_a_true_division(dh):
    root, rinv = attention.divisor(dh)
    assert np.float32(root) == torch.full((), math.sqrt(dh),
                                          dtype=torch.float32).item()
    # every finite bf16 score (the forward's dividends) of magnitude 2^-100
    # or more, and zero (nearer 2^-126 the residual is subnormal and the
    # quotient can be one step off) ...
    bits = np.arange(2 ** 16, dtype=np.uint32) << 16
    scores = bits.view(np.float32)
    scores = scores[np.isfinite(scores) & ((np.abs(scores) >= 2.0 ** -100)
                                           | (scores == 0))]
    # ... and a million f32 dividends over 2^-60 .. 2^60 (the backward's)
    rng = np.random.default_rng(dh)
    n = 10 ** 6
    wide = (rng.uniform(1, 2, n) * np.exp2(rng.integers(-60, 61, n))
            * rng.choice([-1, 1], n)).astype(np.float32)
    for x in (scores, wide):
        got = _kernel_quotient(x, root, rinv)
        want = x / np.float32(root)
        assert np.array_equal(got, want)


TINY = NetConfig(d_model=64, d_ff=128, heads=2, b_local=2, s_local=24,
                 dtype="bfloat16")
TINY_MLA = MlaMoeConfig(
    hidden=64, heads=4, q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
    qk_rope_head_dim=8, v_head_dim=16, intermediate=96, moe_intermediate=24,
    n_routed_experts=16, experts_per_token=4, experts_held=(0, 1, 2, 3),
    vocab_held=64, n_dense_layers=1, n_moe_layers=1, b_local=2, s_local=16,
    init_scale=0.1)


@pytest.mark.parametrize("model,cfg", [(dense, TINY), (mla_moe, TINY_MLA)],
                         ids=["dense", "mla_moe"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_forward_sends_bf16_to_the_wrapper_and_f32_to_the_plain_version(
        monkeypatch, model, cfg, dtype):
    """Every attention of either model's forward reaches the wrapper, in
    the model's type; an f32 one comes back as the plain version's output,
    bit for bit, and the host launches nothing."""
    cfg = dataclasses.replace(cfg, dtype=dtype)
    params = model.init_params(cfg, 3, "cpu")
    batch = model.host_batch(cfg, cfg.b_local, 4)
    want = model.loss_sum(params, batch, cfg)
    seen = []

    def wrapper(q, k, v, scale=None):
        out = causal_attention(q, k, v, scale)
        if q.dtype == torch.float32:
            assert torch.equal(out, attention_reference(q, k, v, scale))
        seen.append(q.dtype)
        return out

    monkeypatch.setattr(model, "causal_attention", wrapper)
    launches = causal_attention.launches
    got = model.loss_sum(params, batch, cfg)
    layers = getattr(cfg, "n_layers", 1)
    assert seen == [getattr(torch, dtype)] * layers
    assert torch.equal(got, want)
    assert causal_attention.launches == launches   # the host launches nothing


def test_forward_on_the_host_is_the_former_chain_bit_for_bit():
    params = step.build_host_params(TINY)
    x = torch.randn((2, 24, 64), generator=torch.Generator().manual_seed(4))
    x = x.to(torch.bfloat16)
    got = dense.forward(params, x, TINY)
    qkv = dense.rms(x) @ params["wqkv"]
    hx = x + former_chain(qkv, TINY.heads)
    ff = torch.nn.functional.gelu(dense.rms(hx) @ params["w_in"],
                                  approximate="tanh") @ params["w_out"]
    assert torch.equal(got, (hx + ff) @ params["w_head"])


@pytest.mark.parametrize("dtype,dh,error", [
    (torch.float16, 64, "bfloat16"),
    (torch.float32, 64, None),              # f32 takes the plain version
    (torch.bfloat16, 520, "head width"),
    (torch.bfloat16, 1024, "head width"),
    (torch.bfloat16, 64, "unsupported device"),
])
def test_wrapper_refuses_what_the_kernels_do_not_take(dtype, dh, error):
    q = torch.empty((1, 8, 2, dh), dtype=dtype, device="meta")
    launches = causal_attention.launches
    if error is None:
        out = causal_attention(q, q, q)
        assert out.shape == (1, 8, 2 * dh) and out.dtype == dtype
    else:
        with pytest.raises(ValueError, match=error):
            causal_attention(q, q, q)
    assert causal_attention.launches == launches


@pytest.mark.parametrize("dqk,dv,scale,error", [
    (192, 128, None, "share shape"),        # two widths need a scale
    (128, 128, 0.1, "with a scale"),        # a scale needs a built pair
    (192, 64, 0.1, "with a scale"),
    (256, 128, 0.1, "with a scale"),
    (192, 128, 0.1, "unsupported device"),  # the pair itself is taken
])
def test_wrapper_refuses_pairs_it_is_not_built_for(dqk, dv, scale, error):
    q = torch.empty((1, 8, 2, dqk), dtype=torch.bfloat16, device="meta")
    v = torch.empty((1, 8, 2, dv), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match=error):
        causal_attention(q, q, v, scale)


def test_wrapper_refuses_q_k_v_of_other_layouts():
    q = torch.empty((1, 8, 2, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="share shape and strides"):
        causal_attention(q, q.transpose(1, 2).contiguous().transpose(1, 2), q)


def test_wrapper_takes_a_pairs_own_strides_and_refuses_other_shapes():
    # with a scale each tensor keeps its own strides (v a view of a wider
    # product); shapes agree but for v's width
    q = torch.empty((1, 8, 2, 192), dtype=torch.bfloat16, device="meta")
    kv = torch.empty((1, 8, 2, 256), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        causal_attention(q, q.transpose(1, 2).contiguous().transpose(1, 2),
                         kv[..., 128:], 0.1)
    for k, v in ((q[:, :4], kv[..., 128:]), (q, kv[:, :7, :, 128:])):
        with pytest.raises(ValueError, match="share shape"):
            causal_attention(q, k, v, 0.1)


def test_built_widths_are_the_librarys():
    # the widths, pairs and kinds the wrapper passes are those the C entry
    # takes: equal widths divide (SCALE false), the pairs take a scale
    src = (Path(attention.__file__).parents[1] / "csrc"
           / "attention.cu").read_text()
    entry = src[src.index("int ko_attention("):]
    entry = entry[:entry.index("}\n")]
    square = re.findall(r"case (\d+): return launch_kind<(\d+), (\d+), false>",
                        entry)
    assert all(a == b == c for a, b, c in square)
    assert tuple(int(w) for w, _, _ in square) == attention.WIDTHS
    pairs = re.findall(r"if \(dqk == (\d+) && dv == (\d+)\) return "
                       r"launch_kind<(\d+), (\d+), true>", entry)
    assert all((a, b) == (c, d) for a, b, c, d in pairs)
    assert tuple((int(a), int(b)) for a, b, _, _ in pairs) == attention.PAIRS
    kinds = re.search(r"enum Kind \{([^}]*)\}", src).group(1)
    assert {name: int(num) for name, num in re.findall(
        r"k(\w+) = (\d)", kinds)} == {k.capitalize(): v for k, v in
                                       attention.KINDS.items()}


@pytest.mark.parametrize("widths", [(w, w) for w in attention.WIDTHS]
                         + list(attention.PAIRS))
def test_backward_launches_the_plan_of_its_widths(widths, monkeypatch):
    """`_launch_backward` makes the launches `BACKWARD` lists for the
    widths, in order (D, then dV, dK and dQ at equal widths; D, the fused
    dK·dV walk and dQ at the pair), each to its outputs, and counts them;
    the library's dispatch takes exactly those kinds at those widths."""
    dqk, dv = widths
    calls = []

    class Library:
        def ko_attention_delta(self, dh, *_):
            calls.append(("delta", dh))
            return 0

        def ko_attention(self, kind, w1, w2, q, k, v, do, lse, delta, out,
                         out2, lse_out, *_):
            calls.append((kind, w1, w2, out, out2))
            return 0

    monkeypatch.setattr(attention, "_library", Library)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    q, k = (torch.zeros((1, 8, 2, dqk), dtype=torch.bfloat16)
            for _ in range(2))
    v, o, do = (torch.zeros((1, 8, 2, dv), dtype=torch.bfloat16)
                for _ in range(3))
    lse = torch.zeros((1, 2, 8))
    launches = causal_attention.launches
    fused = causal_attention.fused_backward_launches
    dq, dk, dvg = attention._launch_backward(
        q, k, v, o, lse, do, dqk, None if dqk == dv else 0.1)
    kinds = attention.BACKWARD[widths]
    assert kinds[0] == "delta" and calls[0] == ("delta", dv)
    outs = {"dv": (dvg, None), "dk": (dk, None), "dq": (dq, None),
            "dkv": (dk, dvg)}
    assert calls[1:] == [
        (attention.KINDS[kind], dqk, dv, *(t if t is None else t.data_ptr()
                                           for t in outs[kind]))
        for kind in kinds[1:]]
    assert attention.LAUNCHES_BACKWARD[widths] == len(kinds) == len(calls)
    assert causal_attention.launches == launches + len(kinds)
    assert causal_attention.fused_backward_launches == fused + (
        "dkv" in kinds)
    # the C dispatch: the pair's branch, then the equal widths'
    src = (Path(attention.__file__).parents[1] / "csrc"
           / "attention.cu").read_text()
    body = src[src.index("int launch_kind("):]
    pair, square = body[:body.index("} else {")], body[body.index("} else {"):]
    branch = pair if dqk != dv else square[:square.index("return cudaErrorInvalidValue")]
    taken = {attention.KINDS[n.lower()] for n in re.findall(
        r"case k(\w+): return", branch)}
    assert taken == {attention.KINDS["fwd"]} | {
        attention.KINDS[kind] for kind in kinds[1:]}


@pytest.mark.parametrize("widths", [(w, w) for w in attention.WIDTHS]
                         + list(attention.PAIRS))
def test_forward_launches_the_walk_of_its_widths(widths, monkeypatch):
    """`_launch_forward` makes one `fwd` launch into o and lse and counts
    it; at the pair it also counts the pipelined forward walk, at equal
    widths not; the library's dispatch sends the pair's forward to the
    pipeline and the equal widths' to the lock-step kernel."""
    dqk, dv = widths
    calls = []

    class Library:
        def ko_attention(self, kind, w1, w2, q, k, v, do, lse, delta, out,
                         out2, lse_out, *_):
            calls.append((kind, w1, w2, out, lse_out))
            return 0

    monkeypatch.setattr(attention, "_library", Library)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    q, k = (torch.zeros((1, 8, 2, dqk), dtype=torch.bfloat16)
            for _ in range(2))
    v = torch.zeros((1, 8, 2, dv), dtype=torch.bfloat16)
    launches = causal_attention.launches
    pipelined = causal_attention.pipelined_forward_launches
    o, lse = attention._launch_forward(q, k, v, dqk,
                                       None if dqk == dv else 0.1)
    assert o.shape == (1, 8, 2, dv) and lse.shape == (1, 2, 8)
    assert calls == [(attention.KINDS["fwd"], dqk, dv, o.data_ptr(),
                      lse.data_ptr())]
    assert causal_attention.launches == launches + attention.LAUNCHES_FORWARD
    assert causal_attention.pipelined_forward_launches == pipelined + (
        dqk != dv)
    src = (Path(attention.__file__).parents[1] / "csrc"
           / "attention.cu").read_text()
    body = src[src.index("int launch_kind("):]
    pair, square = body[:body.index("} else {")], body[body.index("} else {"):]
    branch = pair if dqk != dv else square[:square.index("return cudaErrorInvalidValue")]
    launcher = re.search(r"case kFwd: return (\w+)<", branch).group(1)
    assert launcher == ("launch_pipelined" if dqk != dv else "launch")


@pytest.mark.parametrize("dh,width", [(1, 64), (8, 64), (64, 64), (65, 128),
                                      (96, 128), (200, 256), (512, 512)])
def test_a_head_width_runs_at_the_next_built_width(dh, width):
    assert attention.kernel_width(dh) == width


@pytest.mark.parametrize("dh", [8, 96, 512])
def test_laid_out_reads_the_step_views_in_place_and_pads_other_widths(dh):
    qkv = _qkv(2, 9, 2, dh, torch.bfloat16).detach()
    q, k, v = _heads(qkv, 2)
    laid = attention._laid_out(q, k, v)
    width = attention.kernel_width(dh)
    for t, got in zip((q, k, v), laid):
        if dh == width:             # in place: the split's own views
            assert got.data_ptr() == t.data_ptr()
            assert got.stride() == t.stride()
        else:                       # a zero-padded contiguous copy
            assert got.shape == (2, 9, 2, width) and got.is_contiguous()
            assert torch.equal(got[..., :dh], t)
            assert not got[..., dh:].any()
    out = torch.arange(2 * 9 * 2 * width, dtype=torch.float32).reshape(
        2, 9, 2, width)
    assert torch.equal(attention._unpadded(out, dh),
                       out[..., :dh].reshape(2, 9, 2 * dh))


def test_laid_out_reads_a_pairs_views_in_place():
    gen = torch.Generator().manual_seed(4)
    q, k = (torch.randn((2, 9, 3, 192), generator=gen).bfloat16() for _ in range(2))
    kv = torch.randn((2, 9, 3, 256), generator=gen).bfloat16()
    v = kv[..., 128:]
    laid = attention._laid_out(q, k, v, 0.13)
    for t, got in zip((q, k, v), laid):
        assert got.data_ptr() == t.data_ptr() and got.stride() == t.stride()
    odd = torch.randn((2, 9, 3, 130), generator=gen).bfloat16()[..., 2:]
    got = attention._laid_out(q, k, odd, 0.13)[2]    # rows off 16 bytes
    assert got.is_contiguous() and torch.equal(got, odd)


def test_misaligned_rows_are_copied_at_the_same_width():
    qkv = _qkv(1, 5, 2, 64, torch.bfloat16).detach()
    flat = torch.cat([torch.zeros(1, dtype=torch.bfloat16), qkv.flatten()])
    q = flat[1:].view(qkv.shape)[..., :128].reshape(1, 5, 2, 64)
    assert q.data_ptr() % 16
    (got, *_) = attention._laid_out(q, q, q)
    assert got.data_ptr() % 16 == 0 and got.is_contiguous()
    assert torch.equal(got, q)


@pytest.mark.parametrize("dtype,device,dh,refused", [
    ("bfloat16", "cuda", 1024, True),
    ("bfloat16", "cuda", 512, False),
    ("bfloat16", "cuda", 96, False),
    ("float32", "cuda", 1024, False),
    ("bfloat16", "cpu", 1024, False),
])
def test_step_build_refuses_head_widths_the_kernels_lack(dtype, device, dh,
                                                         refused):
    cfg = NetConfig(d_model=dh, d_ff=64, heads=1, dtype=dtype)
    mesh = SimpleNamespace(device_type=device)
    if refused:
        with pytest.raises(ValidationError, match="head widths up to 512"):
            step.check_attention_width(mesh, cfg)
    else:
        step.check_attention_width(mesh, cfg)


# ---- on the card --------------------------------------------------------

@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no host mode)")
    return torch.device("cuda", 0)


def _on_card(bsz, seq, h, dh, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((bsz, seq, 3 * h * dh), device=dev, generator=gen)
    qkv = qkv.bfloat16().requires_grad_()
    do = torch.randn((bsz, seq, h * dh), device=dev, generator=gen).bfloat16()
    return qkv, do


def _run(fn, qkv, do, h):
    q, k, v = _heads(qkv, h)
    out = fn(q, k, v)
    return (out.detach(), *torch.autograd.grad(out, (q, k, v), do))


# Kernel against the plain version, both on the card, bf16 both ways. Both
# round S to bf16 from f32 sums taken in other orders, and P at another
# point (the kernel before normalising, the chain after); backward, the
# chain rounds dO·vᵀ to bf16 and takes rowsum(dP∘P) where the kernel takes
# rowsum(dO∘O). Each is a rounding of relative size 2^-9 or less on an
# entry, summed over s random terms, so the error in norm stays below one
# bf16 step (2^-8) of each tensor's norm, and no entry's error exceeds a
# few steps of the tensor's largest entry. A wrong tile, row, mask or
# scale is off by the order of the tensor itself.
NORM_TOL, MAX_TOL = 2 ** -8, 2 ** -5


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 100, 2, dh)
                                   for dh in (8, 64, 96, 128, 256, 512)]
                         + [(2, 333, 2, 512), (48, 1024, 8, 512),
                            (6, 8192, 8, 512)])
def test_kernels_match_the_plain_version_on_the_card(dev, shape):
    bsz, seq, h, dh = shape
    qkv, do = _on_card(bsz, seq, h, dh, dev)
    got = _run(causal_attention, qkv, do, h)
    want = _run(attention_reference, qkv, do, h)
    torch.cuda.synchronize()
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        g, w = g.float(), w.float()
        assert bool(torch.isfinite(g).all()), name
        err = (g - w).norm() / w.norm()
        worst = (g - w).abs().max() / w.abs().max()
        assert err <= NORM_TOL and worst <= MAX_TOL, (name, float(err),
                                                      float(worst))


@pytest.mark.cuda
def test_backward_is_bit_identical_run_to_run(dev):
    qkv, do = _on_card(6, 2048, 8, 512, dev, seed=3)
    first = _run(causal_attention, qkv, do, 8)
    second = _run(causal_attention, qkv, do, 8)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,dh,refused", [(torch.float16, 512, True),
                                              (torch.float32, 512, False),
                                              (torch.bfloat16, 520, True),
                                              (torch.bfloat16, 1024, True)])
def test_wrapper_raises_on_the_card_for_what_it_does_not_take(dev, dtype, dh,
                                                              refused):
    q = torch.randn((1, 64, 2, dh), device=dev).to(dtype)
    launches = causal_attention.launches
    if refused:
        with pytest.raises(ValueError):
            causal_attention(q, q, q)
    else:                                   # f32 takes the plain version
        assert torch.equal(causal_attention(q, q, q),
                           attention_reference(q, q, q))
    assert causal_attention.launches == launches


@pytest.mark.cuda
def test_forward_launches_the_kernels_once_forward_and_back(dev):
    cfg = NetConfig(d_model=512, d_ff=1024, heads=8, b_local=2, s_local=256,
                    dtype="bfloat16")
    params = {k: t.to(dev).requires_grad_(t.dim() > 0)
              for k, t in step.build_host_params(cfg).items()}
    x = torch.randn((2, 256, 512), device=dev).bfloat16()
    fwd = attention.LAUNCHES_FORWARD
    bwd = attention.LAUNCHES_BACKWARD[(512, 512)]
    before = causal_attention.launches
    fused = causal_attention.fused_backward_launches
    pipelined = causal_attention.pipelined_forward_launches
    y = dense.forward(params, x, cfg)
    assert causal_attention.launches == before + fwd
    y.float().square().sum().backward()
    torch.cuda.synchronize()
    assert causal_attention.launches == before + fwd + bwd
    assert causal_attention.fused_backward_launches == fused
    assert causal_attention.pipelined_forward_launches == pipelined
    with torch.no_grad():
        dense.forward(params, x, cfg)
    assert causal_attention.launches == before + 2 * fwd + bwd
    f32 = dataclasses.replace(cfg, dtype="float32")
    dense.forward({k: t.detach().float() for k, t in params.items()},
                  x.float(), f32)
    assert causal_attention.launches == before + 2 * fwd + bwd
    # the pair: the pipelined forward walk, three launches back, one of them
    # the fused dK·dV walk
    q, k, kv, do = _latent_on_card(1, 256, 2, dev)
    before = causal_attention.launches
    _latent_run(q, k, kv, do)
    torch.cuda.synchronize()
    assert attention.LAUNCHES_BACKWARD[(192, 128)] == 3
    assert causal_attention.launches == before + fwd + 3
    assert causal_attention.pipelined_forward_launches == pipelined + 1
    assert causal_attention.fused_backward_launches == fused + 1


def _latent_on_card(bsz, seq, h, dev, seed=0):
    """q, k [b, s, h, 192], kv [b, s, h, 256] (v its last 128 columns, a
    strided view) and dO [b, s, h·128], bf16 on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k = (torch.randn((bsz, seq, h, 192), device=dev, generator=gen)
            .bfloat16().requires_grad_() for _ in range(2))
    kv = torch.randn((bsz, seq, h, 256), device=dev, generator=gen).bfloat16()
    do = torch.randn((bsz, seq, h * 128), device=dev, generator=gen).bfloat16()
    return q, k, kv.requires_grad_(), do


LATENT_SCALE = 192 ** -0.5 * (0.1 * math.log(32) + 1) ** 2
# The square widths' limits, with the norm's doubled: the scale puts the
# scores' spread at LATENT_SCALE · sqrt(192) = 1.81 against 1 for 1/sqrt(dh),
# and the bf16 roundings of S and of dO·vᵀ (the chain's) enter the exponent
# and dS in proportion; 2^-7 is still two orders under a wrong tile, row,
# mask or scale
LATENT_NORM_TOL = 2 ** -7


def _latent_run(q, k, kv, do, heads=None):
    """o and the gradients of q, k and v through the kernels (all heads at
    once), or through the plain version `heads` heads at a time."""
    if heads is None:
        out = causal_attention(q, k, kv[..., 128:], LATENT_SCALE)
        dq, dk, dkv = torch.autograd.grad(out, (q, k, kv), do)
        return out.detach(), dq, dk, dkv[..., 128:]
    bsz, seq, h, _ = q.shape
    parts = []
    for h0 in range(0, h, heads):
        sl = slice(h0, h0 + heads)
        x = [t[:, :, sl].detach().requires_grad_()
             for t in (q, k, kv[..., 128:])]
        out = attention_reference(*x, LATENT_SCALE)
        d = do.view(bsz, seq, h, 128)[:, :, sl].reshape(out.shape)
        parts.append((out.detach().view(bsz, seq, -1, 128),
                      *torch.autograd.grad(out, x, d)))
    o, dq, dk, dv = (torch.cat(t, dim=2) for t in zip(*parts))
    return o.reshape(bsz, seq, h * 128), dq, dk, dv


# lengths that cut the 128-row held and 64-row streamed tiles raggedly,
# and b·h that leave the last wave of 132 blocks partial
LATENT_SHAPES = [(1, 100, 2), (2, 333, 4), (1, 8192, 64), (1, 1000, 3),
                 (3, 129, 5), (2, 64, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LATENT_SHAPES)
def test_latent_kernels_match_the_plain_version_on_the_card(dev, shape):
    """K3's (192, 128) kernels, v a view of the kv product, scores times
    the softmax scale: the same two limits as the square widths."""
    q, k, kv, do = _latent_on_card(*shape, dev)
    launches = causal_attention.launches
    pipelined = causal_attention.pipelined_forward_launches
    fused = causal_attention.fused_backward_launches
    got = _latent_run(q, k, kv, do)
    assert causal_attention.launches == launches + attention.LAUNCHES_FORWARD \
        + attention.LAUNCHES_BACKWARD[(192, 128)]
    assert causal_attention.pipelined_forward_launches == pipelined + 1
    assert causal_attention.fused_backward_launches == fused + 1
    want = _latent_run(q, k, kv, do, heads=16)
    torch.cuda.synchronize()
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        g, w = g.float(), w.float()
        assert bool(torch.isfinite(g).all()), name
        err = (g - w).norm() / w.norm()
        worst = (g - w).abs().max() / w.abs().max()
        assert err <= LATENT_NORM_TOL and worst <= MAX_TOL, (
            name, float(err), float(worst))


# the bit-identity tests' shapes: the cell's row length, ragged lengths,
# a second warpgroup past s, one held tile
LATENT_TWIN_SHAPES = [(1, 8192, 64), (1, 1000, 3), (3, 129, 5), (2, 64, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LATENT_TWIN_SHAPES)
def test_latent_forward_is_bit_identical_run_to_run(dev, shape):
    q, k, kv, _ = _latent_on_card(*shape, dev, seed=3)
    x = (q.detach(), k.detach(), kv.detach()[..., 128:], 192, LATENT_SCALE)
    first = attention._launch_forward(*x)
    second = attention._launch_forward(*x)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LATENT_TWIN_SHAPES)
def test_latent_backward_is_bit_identical_run_to_run(dev, shape):
    q, k, kv, do = _latent_on_card(*shape, dev, seed=3)
    first = _latent_run(q, k, kv, do)
    second = _latent_run(q, k, kv, do)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
