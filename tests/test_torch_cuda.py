"""Kernel K1 on the card against its plain version. Needs a CUDA card and
nvcc; skips elsewhere. Imports neither JAX nor the JAX package, so it runs
on a machine without them:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import pytest
import torch

from kubeoperator_tpu_torch.ops import dma_read as port

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


def test_bandwidth_runs_through_the_kernel(dev):
    before = port.dma_read.launches
    r = port.dma_read_bandwidth_gbps(size_mb=16.0, iters=16)
    assert r.gbps > 0 and port.dma_read.launches > before
