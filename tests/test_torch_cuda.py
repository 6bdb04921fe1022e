"""Kernels K1 and K2 on the card against their plain versions, ring
attention and its bf16 product's gradient on the card, one training step
of the validation net, and one step and one forward of the tenant
workload against the same on the host, the bench twin's line, the graft
block against the host, the dry run on one card, the DCN smoke on four
cards and the `koctl workload` verbs' chain. Needs a CUDA card and nvcc; skips elsewhere. Imports neither
JAX nor the JAX package, so it runs on a machine without them:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import json

import pytest
import torch

from kubeoperator_tpu_torch.ops import dma_read as port
from kubeoperator_tpu_torch.ops import ring_gather

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no host mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("rows", [256, 2048, 62464])
def test_kernel_on_ones_is_exact(dev, rows):
    x = torch.ones((rows, 1024), device=dev)
    before = port.dma_read.launches
    out = port.dma_read(x, torch.tensor([2.0], device=dev))
    torch.cuda.synchronize()
    assert port.dma_read.launches == before + 1
    assert torch.equal(out, torch.full((8, 1024), rows / 8 + 2.0, device=dev))


@pytest.mark.parametrize("rows", [256, 2048, 62464])
def test_kernel_matches_plain_version(dev, rows):
    # same values summed in another order: <= 7,808 normals per output,
    # random-walk rounding ~1e-4 at the largest size
    x = torch.randn((rows, 1024), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(rows))
    seed = torch.tensor([0.5], device=dev)
    out = port.dma_read(x, seed)
    ref = port.dma_read_reference(x, seed)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-3)
    # fixed summation order: the same bits on every run
    assert torch.equal(out, port.dma_read(x, seed))


def test_kernel_is_bit_identical_and_resets_its_tickets(dev):
    # the finish runs inside the launch: 100 launches give the same bits,
    # and the last finisher of each leaves the ticket counters at zero
    x = torch.randn((62464, 1024), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(5))
    seed = torch.tensor([0.25], device=dev)
    first = port.dma_read(x, seed)
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(100):
        bad += (port.dma_read(x, seed) != first).sum()
    torch.cuda.synchronize()
    assert int(bad.item()) == 0
    scratch = port._stream_scratch(x.device, torch.cuda.current_stream(dev))
    assert scratch.counters.tolist() == [0, 0]


def test_kernel_on_two_streams_keeps_a_scratch_each(dev):
    # launches on two streams may overlap; each stream has its own
    # partials and ticket counters, so neither mixes the other's tickets
    x = torch.randn((62464, 1024), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(6))
    seed = torch.tensor([0.75], device=dev)
    want = port.dma_read(x, seed)
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    bad = [torch.zeros((), dtype=torch.int64, device=dev) for _ in streams]
    torch.cuda.synchronize()
    for _ in range(50):
        for s, b in zip(streams, bad):
            with torch.cuda.stream(s):
                b += (port.dma_read(x, seed) != want).sum()
    torch.cuda.synchronize()
    assert [int(b.item()) for b in bad] == [0, 0]
    a, b = (port._stream_scratch(x.device, s) for s in streams)
    assert a is not b and a.counters.tolist() == b.counters.tolist() == [0, 0]


def test_bandwidth_runs_through_the_kernel(dev):
    before = port.dma_read.launches
    r = port.dma_read_bandwidth_gbps(size_mb=16.0, iters=16)
    assert r.gbps > 0 and port.dma_read.launches > before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_ring_kernel_is_exact(dev, n, dtype):
    x = torch.randn((64 * n, 1024), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(n)).to(dtype)
    before = ring_gather.ring_all_gather.launches
    out = ring_gather.ring_all_gather(x, ranks=n)
    ref = ring_gather.ring_all_gather_reference(x.view(n, 64, 1024))
    torch.cuda.synchronize()
    assert ring_gather.ring_all_gather.launches == before + 1
    assert torch.equal(out, x.expand(n, -1, -1))
    assert torch.equal(out, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_ring_kernel_is_exact_on_ragged_pieces(dev, n, dtype):
    # 1,001-row shards: no block's range is a whole number of pieces
    rows = 1001
    x = torch.randn((rows * n, 1024), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(n)).to(dtype)
    out = ring_gather.ring_all_gather(x, ranks=n)
    ref = ring_gather.ring_all_gather_reference(x.view(n, rows, 1024))
    torch.cuda.synchronize()
    assert torch.equal(out, x.expand(n, -1, -1))
    assert torch.equal(out, ref)
    ring_gather.raise_on_ring_error()


def test_ring_error_word_stays_clear_over_repeats(dev):
    xs = [torch.randn((8 * 256, 1024), device=dev) for _ in range(2)]
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(50):
        x = xs[i % 2]
        bad += (ring_gather.ring_all_gather(x, ranks=8)
                != x.expand(8, -1, -1)).sum()
    assert int(bad.item()) == 0
    ring_gather.raise_on_ring_error()  # raises if any wait timed out


def test_ring_drivers_run_through_the_kernel(dev):
    before = ring_gather.ring_all_gather.launches
    assert ring_gather.verify_ring_all_gather(ranks=8, device=dev) is True
    r = ring_gather.bench_ring_all_gather(size_mb=4.0, iters=4, ranks=4,
                                          device=dev)
    assert r.busbw_gbps > 0
    assert ring_gather.ring_all_gather.launches > before


def test_ring_attention_verifies_at_world_one(dev):
    from kubeoperator_tpu_torch.ops import longcontext_check
    from kubeoperator_tpu_torch.parallel.multislice import initialize_from_env

    initialize_from_env()
    assert longcontext_check.verify_ring_attention() is True
    assert longcontext_check.verify_ring_attention(causal=False) is True


def _bf16_grads_hold_to_float64(ga, gb, a, b, w):
    """The gradients of sum(w * (a @ b)) against float64 autograd with the
    unrounded w: rounded to bf16 once, the float64 result is hit on all but
    a few ties (the reference's f32 x bf16 transpose does the same), while a
    cotangent rounded to bf16 before its products misses about 40% of it;
    every entry stays within one bf16 step (2^-7 relative at worst)."""
    a64, b64 = (t.detach().double().requires_grad_() for t in (a, b))
    ra, rb = torch.autograd.grad(((a64 @ b64) * w.double()).sum(), (a64, b64))
    for got, want in ((ga, ra), (gb, rb)):
        assert got.dtype == torch.bfloat16
        assert (got.cpu() != want.cpu().to(torch.bfloat16)).float().mean() <= 0.01
        torch.testing.assert_close(got.double(), want, rtol=2 ** -7, atol=1e-6)


def test_bmm_dtype_gradient(dev):
    # aten::bmm.dtype has no derivative formula; _BmmF32 supplies one. The
    # forward sums exact bf16 x bf16 products in f32; the gradients take the
    # f32 cotangent unrounded, so they are float64's rounded to bf16 but for
    # a few ties
    from kubeoperator_tpu_torch.parallel import longcontext as lc

    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((2, 4, 64, 32), device=dev, generator=gen).bfloat16()
    b = torch.randn((2, 4, 32, 48), device=dev, generator=gen).bfloat16()
    w = torch.randn((2, 4, 64, 48), device=dev, generator=gen)
    a.requires_grad_()
    b.requires_grad_()
    out = lc._bmm_f32(a, b)
    assert out.dtype == torch.float32 and out.grad_fn is not None
    torch.testing.assert_close(out.detach().double(),
                               a.detach().double() @ b.detach().double(),
                               rtol=1e-6, atol=1e-5)
    _bf16_grads_hold_to_float64(*torch.autograd.grad((out * w).sum(), (a, b)),
                                a, b, w)


def test_train_step_at_the_default_config(dev):
    # the default NetConfig (f32) on one card, mesh (1,1,1,1): the first
    # two losses the reference gives on the host for the same seed; f32
    # products (no TF32) in another summation order stay within 1e-5
    from kubeoperator_tpu_torch.ops.train_smoke import run_train_smoke
    from kubeoperator_tpu_torch.parallel.multislice import initialize_from_env

    initialize_from_env()
    r = run_train_smoke(steps=2)
    assert r["ok"] is True and r["devices"] == 1
    assert r["mesh"] == {"dp": 1, "pp": 1, "sp": 1, "tp": 1}
    assert r["losses"] == pytest.approx([0.19579065, 0.19051692], rel=1e-5)


def test_workload_step_and_forward_match_the_host(dev):
    # the default NetConfig (f32, no TF32) on mesh (1,1,1): one pjit AdamW
    # step and one forward on the card against the same functions on the
    # host's copies of the same tensors. Loss and output: 1e-5 relative
    # (other summation orders); parameters: 1e-6 absolute but for entries
    # whose gradient is within rounding of 0 (Adam's first update is
    # lr·sign(g): at most 2·lr off, on at most 0.5% of a leaf); moments
    # 1e-5 relative plus 1e-7 (mu) or 1e-12 (nu) absolute
    from kubeoperator_tpu_torch.parallel.mesh import MeshSpec
    from kubeoperator_tpu_torch.parallel.multislice import initialize_from_env
    from kubeoperator_tpu_torch.workloads import partition, serve, step

    initialize_from_env()
    mesh = MeshSpec.parse("data=1,fsdp=1,tp=1").build("cuda")
    step_fn, specs, used = step.make_train_step(mesh)
    assert used == "pjit"
    host = step.build_host_state()
    shard, _ = partition.make_shard_and_gather_fns(mesh, specs)
    x = step.build_batch(mesh)
    loss, new = step_fn(shard(host), x)
    host_loss, host_new = step_fn(host, x.cpu())
    torch.testing.assert_close(loss.cpu(), host_loss, rtol=1e-5, atol=0)
    got = dict(partition.tree_paths(new))
    for path, want in partition.tree_paths(host_new):
        have = got[path].cpu()
        if path.startswith("params/") and want.dim():
            off = (have - want).abs()
            assert (off > 1e-6).float().mean() <= 5e-3, path
            assert off.max() <= 2 * step.ADAMW_LR, path
        elif "/mu/" in path or "/nu/" in path:
            atol = 1e-7 if "/mu/" in path else 1e-12
            torch.testing.assert_close(have, want, rtol=1e-5, atol=atol)
        else:
            assert torch.equal(have, want), path
    fwd, pspecs, _ = serve.make_forward(mesh)
    pshard, _ = partition.make_shard_and_gather_fns(mesh, pspecs)
    y = fwd(pshard(host["params"]), x)
    torch.testing.assert_close(y.cpu(), fwd(host["params"], x.cpu()),
                               rtol=1e-5, atol=1e-6)


def test_bench_line_on_the_card(dev, monkeypatch, capsys):
    # the 1-rank bench on the card, cut to size: one matmul size and the
    # BENCH_CONFIG run at the default width in bf16; the line's contract,
    # the card's metric name, and K1 launched by its read stream
    from kubeoperator_tpu_torch import bench
    from kubeoperator_tpu_torch.parallel.multislice import initialize_from_env
    from kubeoperator_tpu_torch.parallel.topology import generation_for_device
    from kubeoperator_tpu_torch.parallel.validation_net import NetConfig

    initialize_from_env()
    monkeypatch.setattr(bench, "MXU_SWEEP", ((2048, 100),))
    monkeypatch.setattr(bench, "BENCH_CONFIG", NetConfig(dtype="bfloat16"))
    before = port.dma_read.launches
    assert bench.main([]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    gen = generation_for_device(dev)
    assert list(line) == ["metric", "value", "unit", "vs_baseline", "details"]
    assert line["metric"] == f"{gen.name}_single_chip_mxu_bf16_tflops"
    d = line["details"]
    assert d["devices"] == 1 and d["device_kind"] == torch.cuda.get_device_name(dev)
    assert isinstance(d["dma_read_gbps"], float) and d["dma_read_gbps"] > 0
    assert port.dma_read.launches > before
    assert d["train_smoke_ok"] is True and d["train_bench_ok"] is True
    assert "prior_run" not in d


def test_graft_block_on_the_card_matches_the_host(dev):
    # bf16 both ways; f32 accumulation on the card (aten::bmm.dtype) and
    # exact widening on the host: a few bf16 steps of the O(1) outputs at
    # the full block; at a reduced block equal but for at most 1% of the
    # entries (sums in another order rounding the other way), each within
    # one bf16 step of the inputs' scale
    from kubeoperator_tpu_torch import graft_entry

    fn, args = graft_entry.entry()
    assert all(a.device.type == "cuda" for a in args)
    got = fn(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (4, 512, 1024)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float().cpu(),
                               fn(*(a.cpu() for a in args)).float(),
                               rtol=2e-2, atol=2e-2)
    small = graft_entry.block_inputs(2, 64, 256)
    got, want = fn(*(a.to(dev) for a in small)).cpu(), fn(*small)
    assert float((got != want).float().mean()) <= 0.01
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=2 ** -6)


def test_dryrun_on_one_card(dev):
    from kubeoperator_tpu_torch import graft_entry

    got = graft_entry.dryrun_multichip(1, device="cuda")
    assert got["devices"] == 1 and got["device_type"] == "cuda"
    assert got["loss"] == pytest.approx(0.19579065, rel=1e-5)


def test_dcn_smoke_one_rank_a_card(dev):
    # v5p-16 x 2 as 4 NCCL ranks, one a card: both sums 1 + 2
    from kubeoperator_tpu_torch.ops.dcn_smoke import run_dcn_smoke

    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 cards, one rank a card")
    got = run_dcn_smoke(device="cuda")
    assert got["ok"], got["errors"]
    assert got["dcn_psum"] == [3.0] and got["ici_psum"] == [3.0]


def test_workload_verbs_chain_on_the_card(dev, tmp_path, capsys):
    # `koctl workload` on the card at the default config: train, train
    # drained at step 2 into a checkpoint, its resume (the drained and
    # resumed losses are the uninterrupted run's exactly), serve from the
    # resumed checkpoint and the sweep; no hand-written kernel runs
    from kubeoperator_tpu_torch.cli import koctl

    # the counts are this process's: earlier tests may have launched both
    before = {"dma_read": port.dma_read.launches,
              "ring_all_gather": ring_gather.ring_all_gather.launches}

    def verb(*argv):
        rc = koctl.main(["workload", *argv, "--json"])
        out = json.loads(capsys.readouterr().out)
        assert out["ok"] == (rc == 0)
        assert out["device"]["type"] == "cuda"
        assert out["device"]["kernel_launches"] == before
        return out

    ckpt = ("--checkpoint-dir", str(tmp_path))
    full = verb("train", "--steps", "4")
    drained = verb("train", "--steps", "4", "--drain-at", "2", *ckpt)
    resumed = verb("train", "--resume", *ckpt)
    assert drained["result"]["losses"] + resumed["result"]["losses"] \
        == full["result"]["losses"]
    assert full["ok"] and full["device"]["peak_memory_bytes"] > 0
    served = verb("serve", "--requests", "2", *ckpt)
    assert served["ok"] and served["result"]["served"] == 2
    swept = verb("sweep", "--steps", "2")
    assert swept["result"]["rows"][0]["losses"] == full["result"]["losses"][:2]
