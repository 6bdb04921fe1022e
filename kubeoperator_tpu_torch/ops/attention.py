"""Fused causal attention of the tenant models (kernel K3).

`causal_attention(q, k, v)` is the attention of
`workloads/dense.py::forward`: q, k and v are [b, s, h, dh] (there, views
of one qkv product with row stride 3·h·dh), the output [b, s, h·dh].
`causal_attention(q, k, v, scale)` is latent attention's
(`workloads/mla_moe.py`): q and k [b, s, h, 192], v [b, s, h, 128] (a view
of the kv product, its own strides), the scores times `scale` in place of
the division by sqrt(dh), the output [b, s, h·128].
The wrapper alone picks the path: a bf16 CUDA input goes through
hand-written CUDA kernels (`csrc/attention.cu`, built by `ops/_build.py`;
its header note gives the design), one launch forward and, back, the kinds
`BACKWARD` lists for the widths (four at equal widths, three at the pair),
held in a `torch.autograd.Function`; an f32 or CPU input takes
`attention_reference`, the plain PyTorch chain, operation for operation;
any other input raises. `causal_attention.launches` counts the kernels'
launches: `LAUNCHES_FORWARD` a forward, `LAUNCHES_BACKWARD[(dqk, dv)]` a
backward; `causal_attention.pipelined_forward_launches` the pair's
pipelined forward walk, `causal_attention.fused_backward_launches` its
fused dK·dV walk.

Source note:

* It replaces no TPU kernel: the JAX package writes this chain as plain
  `jnp` and leaves it to XLA's fusion. On the card the eager chain wrote
  [b, h, s, s] f32 scores to device memory and swept them about a dozen
  times forward and back: at 8 heads of 8192-token rows, 12.9 GB a sweep.
  The kernels keep each tile of scores in registers.
* What bounds it on the H100: the products (two b·h·s²·dh products over
  the causal half forward, eight back at equal widths, seven at the pair),
  run by wgmma from tiles in shared memory; at dh = 512 far above the
  card's 295 operations a byte, and in practice held back by re-reading
  the streamed tiles from L2 and by the softmax running between the
  products. At the pair the forward and the backward are warp-specialised
  walks fed by TMA, which overlap those (the kernels' header).
* The library is built for head widths `WIDTHS` (q, k and v alike) and
  for the pairs of q·k and v widths in `PAIRS`, which take a scale. A head
  width between the `WIDTHS` runs at the next one up, q, k and v copied
  into zero-padded [b, s, h, w] tensors (zero columns add exact zeros to
  every sum); so does a layout whose rows are not 16-byte aligned (a pair
  is copied at its own widths). Widths above `MAX_DH` raise: a [64, dh]
  f32 accumulator would not fit the register file; so does a pair not in
  `PAIRS`, or a scale with equal widths.
* Same rounding points as the chain, except where the kernel normalises
  (after P·v, the chain before its cast of P to bf16); see the kernels'
  header.
"""

from __future__ import annotations

import ctypes
import functools
import math
import re

import numpy as np
import torch

from kubeoperator_tpu_torch.ops import _build

WIDTHS = (64, 128, 256, 512)   # head widths the library is built for
PAIRS = ((192, 128),)          # (q·k width, v width) built with a scale
MAX_DH = WIDTHS[-1]
MASK = -1e30
KINDS = {"fwd": 0, "dv": 1, "dk": 2, "dq": 3, "dkv": 4}
# the backward's launches at each built pair of widths, in order: D, then
# the walks (at the pair one fused dK·dV walk in place of dV and dK)
BACKWARD = {**{(w, w): ("delta", "dv", "dk", "dq") for w in WIDTHS},
            (192, 128): ("delta", "dkv", "dq")}
LAUNCHES_FORWARD = 1
LAUNCHES_BACKWARD = {widths: len(kinds) for widths, kinds in BACKWARD.items()}


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float | None = None) -> torch.Tensor:
    """Plain version: the dense stage's eager chain, operation for
    operation. The logits product comes out in q's type, is widened to f32
    and only then divided by sqrt(dh) (a 0-d tensor on q's device: a CUDA
    kernel divides by a host scalar through its reciprocal, which rounds
    differently), or multiplied by `scale` as an f32 0-d tensor when one is
    given; the causal mask is -1e30; softmax in f32, cast back. v may be
    narrower than q and k: the output is [b, s, h·(v's width)]."""
    bsz, seq, h, dh = q.shape
    logits = torch.einsum("bqhe,bkhe->bhqk", q, k).float()
    if scale is None:
        root = torch.full((), math.sqrt(dh), dtype=torch.float32,
                          device=q.device)
        logits = logits / root
    else:
        logits = logits * torch.full((), scale, dtype=torch.float32,
                                     device=q.device)
    causal = torch.ones((seq, seq), dtype=torch.bool, device=q.device).tril()
    logits = torch.where(causal, logits, MASK)
    attn = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhe->bqhe", attn, v).reshape(
        bsz, seq, h * v.shape[3])


def kernel_width(dh: int) -> int:
    """The built head width that a head width of `dh` runs at."""
    return next(w for w in WIDTHS if w >= dh)


def unbuilt_widths(dqk: int, dv: int, scaled: bool) -> str | None:
    """None where the kernels take q·k heads `dqk` and v heads `dv` wide
    (`scaled`: a pair, with a scale), else what they take instead; the
    wrapper and the step's build-time check both ask here."""
    if not scaled:
        return None if dqk <= MAX_DH else f"head widths up to {MAX_DH}, not {dqk}"
    return None if (dqk, dv) in PAIRS else (
        f"latent attention's head widths {PAIRS} with a scale, not {(dqk, dv)}")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           scale: float | None = None) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16 on CUDA, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if scale is None and (t.shape != q.shape or t.stride() != q.stride()):
            raise ValueError(
                f"q, k and v must share shape and strides, got {name} "
                f"{tuple(t.shape)} {t.stride()}, "
                f"q {tuple(q.shape)} {q.stride()}")
        width = t.shape[3:] if name == "v" else q.shape[3:]
        if scale is not None and t.shape != q.shape[:3] + width:
            raise ValueError(
                f"q, k and v must share shape (v its own head width) with a "
                f"scale, got {name} {tuple(t.shape)}, q {tuple(q.shape)}")
    if q.dim() != 4 or q.numel() == 0:
        raise ValueError(f"q must be a non-empty [b, s, h, dh], got "
                         f"{tuple(q.shape)}")
    why = unbuilt_widths(q.shape[3], v.shape[3], scale is not None)
    if why:
        raise ValueError(f"the kernels take {why}")
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float | None = None) -> torch.Tensor:
    """Causal softmax attention of [b, s, h, dh] q, k, v as [b, s, h·dh]
    (with `scale`: v of a pair's narrower width, the output at v's width):
    the kernels for bf16 CUDA tensors (saving what backward needs only
    where a gradient is wanted), the plain version for f32 tensors on any
    device and for CPU tensors; ValueError for any other input."""
    if q.dtype == torch.float32 or q.device.type == "cpu":
        return attention_reference(q, k, v, scale)
    _check(q, k, v, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FusedCausalAttention.apply(q, k, v, scale)
    dh = v.shape[3]
    return _unpadded(_launch_forward(*_laid_out(q, k, v, scale), q.shape[3],
                                     scale)[0], dh)


causal_attention.launches = 0
causal_attention.pipelined_forward_launches = 0
causal_attention.fused_backward_launches = 0


class _FusedCausalAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        dh, dv = q.shape[3], v.shape[3]
        q, k, v = _laid_out(q, k, v, scale)
        o, lse = _launch_forward(q, k, v, dh, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.dh, ctx.scale = dh, scale
        return _unpadded(o, dv)

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dh, scale = ctx.dh, ctx.scale
        if scale is not None:           # a pair: its own widths, no padding
            do = _padded(do.reshape(o.shape), o.shape[3])
            return (*_launch_backward(q, k, v, o, lse, do, dh, scale), None)
        do = _padded(do.reshape(*o.shape[:3], dh), o.shape[3])
        return (*(g if g.shape[3] == dh else g[..., :dh]
                  for g in _launch_backward(q, k, v, o, lse, do, dh)), None)


def _padded(t: torch.Tensor, width: int) -> torch.Tensor:
    """`t` [b, s, h, dh] as a contiguous, 16-byte aligned [b, s, h, width],
    zero-filled past dh."""
    if t.shape[3] == width and t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    out = t.new_zeros((*t.shape[:3], width))
    out[..., :t.shape[3]] = t
    return out


def _in_place(t: torch.Tensor) -> bool:
    """Whether the kernels read `t` as it lies: head columns contiguous,
    rows and heads starting 16-byte aligned."""
    return (t.stride(3) == 1 and all(s % 8 == 0 for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def _laid_out(q, k, v, scale=None):
    """q, k and v as the kernels read them: in place where dh is a built
    width and rows and heads start 16-byte aligned, else zero-padded
    copies at the next built width; a pair (`scale` given) each in place
    or copied at its own width."""
    if scale is not None:
        return tuple(t if _in_place(t) else _padded(t, t.shape[3])
                     for t in (q, k, v))
    width = kernel_width(q.shape[3])
    if q.shape[3] == width and all(_in_place(t) for t in (q, k, v)):
        return q, k, v
    return tuple(_padded(t, width) for t in (q, k, v))


def _unpadded(o: torch.Tensor, dh: int) -> torch.Tensor:
    """The kernels' [b, s, h, width] output as [b, s, h·dh]."""
    bsz, seq, h, width = o.shape
    if width != dh:
        o = o[..., :dh]
    return o.reshape(bsz, seq, h * dh)


def divisor(dh: int) -> tuple[float, float]:
    """sqrt(dh) in f32 and r, the f32 nearest its reciprocal. The kernels
    divide x by the first as t = x·r, then t + fma(-t, root, x)·r: one fma
    step that gives the correctly rounded f32 quotient for any x of
    magnitude 2^-100 or more (Markstein's theorem: r within half an ulp of
    the reciprocal, t within one ulp of the quotient), as a true division
    does, in three operations where `div.rn.f32` takes about twice as many
    and a slow-path check."""
    root = np.float32(math.sqrt(dh))
    return float(root), float(np.float32(1) / root)


def factors(dh: int, scale: float | None) -> tuple[float, float]:
    """The kernels' (root, rinv): `divisor(dh)`, or with a scale (0, the
    f32 nearest the scale), which the pair's kernels multiply by."""
    if scale is None:
        return divisor(dh)
    return 0.0, float(np.float32(scale))


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("attention")
    vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)
    lib.ko_attention.argtypes = [i32, i32, i32, *[vp] * 9, *[i64] * 9, i32,
                                 i32, i32, f32, f32, vp]
    lib.ko_attention_delta.argtypes = [i32, vp, vp, vp, i32, i32, i32, vp]
    lib.ko_attention_smem.argtypes = [i32, i32, i32]
    for fn in (lib.ko_attention, lib.ko_attention_delta,
               lib.ko_attention_smem):
        fn.restype = ctypes.c_int
    return lib


def _ok(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"K3 {what}: launch failed, cudaError {status}")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _launch(kind: str, q, k, v, out, dh: int, scale=None, do=None,
            lse=None, delta=None, lse_out=None, out2=None) -> None:
    bsz, seq, h, width = q.shape
    _ok(_library().ko_attention(
        KINDS[kind], width, v.shape[3], _ptr(q), _ptr(k), _ptr(v), _ptr(do),
        _ptr(lse), _ptr(delta), _ptr(out), _ptr(out2), _ptr(lse_out),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], bsz, h, seq,
        *factors(dh, scale), torch.cuda.current_stream(q.device).cuda_stream),
        kind)


def _launch_forward(q, k, v, dh: int | None = None,
                    scale: float | None = None):
    """o [b, s, h, v's width] and lse [b, h, s] (f32) for q, k, v as the
    kernels read them (`_laid_out`); `dh`, the head width before padding,
    sets the divisor (default: q's width) where no `scale` is given."""
    bsz, seq, h, width = q.shape
    o = torch.empty((bsz, seq, h, v.shape[3]), dtype=q.dtype, device=q.device)
    lse = torch.empty((bsz, h, seq), dtype=torch.float32, device=q.device)
    _launch("fwd", q, k, v, o, dh or width, scale, lse_out=lse)
    causal_attention.launches += LAUNCHES_FORWARD
    causal_attention.pipelined_forward_launches += int(
        (width, v.shape[3]) in PAIRS)
    return o, lse


def _launch_backward(q, k, v, o, lse, do, dh: int | None = None,
                     scale: float | None = None):
    """dq, dk (contiguous [b, s, h, q's width]) and dv (v's width) for a
    contiguous dO shaped as o, from `_launch_forward`'s o and lse: the
    launches `BACKWARD` lists for the widths."""
    bsz, seq, h, width = q.shape
    kinds = BACKWARD[(width, v.shape[3])]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    delta = torch.empty_like(lse)
    _ok(_library().ko_attention_delta(o.shape[3], o.data_ptr(), do.data_ptr(),
                                      delta.data_ptr(), bsz, h, seq, stream),
        "delta")
    dq, dk = (torch.empty(q.shape, dtype=q.dtype, device=q.device)
              for _ in range(2))
    dv = torch.empty(o.shape, dtype=q.dtype, device=q.device)
    outs = {"dv": (dv, None), "dk": (dk, None), "dq": (dq, None),
            "dkv": (dk, dv)}
    for kind in kinds[1:]:
        out, out2 = outs[kind]
        _launch(kind, q, k, v, out, dh or width, scale, do=do, lse=lse,
                delta=delta, out2=out2)
    causal_attention.launches += len(kinds)
    causal_attention.fused_backward_launches += int("dkv" in kinds)
    return dq, dk, dv


def kernel_resources() -> dict:
    """Registers a thread, spilled bytes and shared memory bytes (static
    plus dynamic) of each kernel at each built width, from ptxas's report
    when the library was built: {"fwd512": {...}, "fwd192x128": {...},
    "delta512": {...}, ...}."""
    lib = _library()
    names = {str(v): k for k, v in KINDS.items()}
    out = {}
    for entry in _build.build_log("attention").split(
            "Compiling entry function")[1:]:
        kernel = re.search(
            r"attention_kernel(?:_pipelined)?ILi(\d)ELi(\d+)ELi(\d+)E", entry)
        delta = re.search(r"delta_kernelILi(\d+)E", entry)
        regs = re.search(r"Used (\d+) registers", entry)
        if not (kernel or delta) or not regs:
            continue
        spills = re.search(r"(\d+) bytes spill stores", entry)
        static = re.search(r"(\d+) bytes smem", entry)
        shared = int(static.group(1)) if static else 0
        if kernel:
            kind, dqk, dv = (int(g) for g in kernel.groups())
            name = names[str(kind)] + (str(dqk) if dqk == dv
                                       else f"{dqk}x{dv}")
            shared += lib.ko_attention_smem(kind, dqk, dv)
        else:
            name = "delta" + delta.group(1)
        out[name] = dict(n_regs=int(regs.group(1)),
                         n_spills=int(spills.group(1)) if spills else 0,
                         shared=shared)
    return out
