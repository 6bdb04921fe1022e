"""Kernel K1 (explicit-copy read stream): the port's plain version against
the interpreted Pallas kernel of the JAX package, on the same numpy inputs.

On the host `dma_read` takes its plain PyTorch version; the CUDA kernel
itself is held against that version on the card (test_torch_cuda.py and
chip_smoke.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeoperator_tpu.ops import pallas_kernels as jax_kernels
from kubeoperator_tpu_torch.ops import dma_read as port


def _both(x: np.ndarray, seed: np.ndarray):
    want = np.asarray(jax_kernels._dma_read(
        jnp.asarray(x), jnp.asarray(seed), interpret=True))
    got = port.dma_read(torch.from_numpy(x), torch.from_numpy(seed)).numpy()
    return got, want


@pytest.mark.parametrize("rows", [256, 512, 1024])
def test_ones_bit_exact_against_interpreted_pallas(rows):
    # integer sums below 2^24: exact in f32 whatever the summation order
    got, want = _both(np.ones((rows, 1024), np.float32),
                      np.array([3.0], np.float32))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (8, 1024)
    assert np.all(got == rows / 8 + 3.0)


@pytest.mark.parametrize("rows", [256, 512, 1024])
def test_random_against_interpreted_pallas(rows):
    # both add the same f32 values in different orders (chunked fori_loop
    # vs one reduction): <= 128 terms of magnitude ~1, so atol 1e-4 covers
    # the rounding-order difference with a wide margin
    rng = np.random.default_rng(rows)
    x = rng.standard_normal((rows, 1024)).astype(np.float32)
    got, want = _both(x, np.array([0.5], np.float32))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_row_r_lands_in_accumulator_row_r_mod_8():
    x = np.zeros((256, 1024), np.float32)
    x[13, 7] = 1.0  # 13 % 8 == 5
    got, want = _both(x, np.array([0.0], np.float32))
    np.testing.assert_array_equal(got, want)
    assert got[5, 7] == 1.0 and got.sum() == 1.0


@pytest.mark.parametrize("case", [
    "rows_not_multiple_of_256", "float16", "non_contiguous", "seed_shape",
    "seed_dtype", "zero_rows", "wrong_width",
])
def test_invalid_inputs_raise_value_error(case):
    x = torch.ones((256, 1024))
    seed = torch.zeros(1)
    if case == "rows_not_multiple_of_256":
        x = torch.ones((300, 1024))
    elif case == "float16":
        x = x.half()
    elif case == "non_contiguous":
        x = torch.ones((1024, 256)).t()
    elif case == "seed_shape":
        seed = torch.zeros(2)
    elif case == "seed_dtype":
        seed = torch.zeros(1, dtype=torch.float64)
    elif case == "zero_rows":
        x = torch.ones((0, 1024))
    elif case == "wrong_width":
        x = torch.ones((256, 512))
    with pytest.raises(ValueError):
        port.dma_read(x, seed)


@pytest.mark.parametrize("rows, nblocks", [
    (256, 32),      # 32 tiles: the grid is capped at one block a tile
    (2048, 132),
    (62464, 132),   # tpu diag's 256 MB: 7,808 tiles, 59 or 60 a block
    (62464, 264),
    (62464, 7808),
])
def test_tile_plan_covers_each_tile_once_in_even_shares(rows, nblocks):
    tiles = rows // port.TILE_ROWS
    plan = port.tile_plan(tiles, nblocks)
    assert len(plan) == nblocks <= tiles
    covered = np.zeros(tiles, np.int64)
    for b, mine in enumerate(plan):
        # round-robin: block b streams b, b + nblocks, ... in order
        assert list(mine) == list(range(b, tiles, nblocks)) and len(mine) > 0
        covered[list(mine)] += 1
    np.testing.assert_array_equal(covered, 1)
    counts = {len(mine) for mine in plan}
    assert max(counts) - min(counts) <= 1  # even
    # at any step k the grid reads one window of neighbouring tiles
    for k in range(min(len(mine) for mine in plan)):
        window = [mine[k] for mine in plan]
        assert window == list(range(k * nblocks, (k + 1) * nblocks))


def test_tile_plan_refuses_more_blocks_than_tiles():
    with pytest.raises(ValueError):
        port.tile_plan(32, 33)
    with pytest.raises(ValueError):
        port.tile_plan(32, 0)


@pytest.mark.parametrize("nblocks, want", [(1, 1), (3, 2), (32, 32),
                                           (132, 64), (264, 64)])
def test_finishers_split_the_output_evenly(nblocks, want):
    f = port.finisher_count(nblocks)
    assert f == want and f <= nblocks and (8 * 1024) % f == 0


def test_host_tensors_take_the_plain_version_and_count_no_launch():
    before = port.dma_read.launches
    x = torch.ones((256, 1024))
    out = port.dma_read(x, torch.tensor([1.0]))
    assert torch.equal(out, port.dma_read_reference(x, torch.tensor([1.0])))
    assert port.dma_read.launches == before


def test_bandwidth_without_device_raises_when_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.dma_read_bandwidth_gbps()


def test_result_keys_match_reference_and_cpu_clamp():
    assert ([f.name for f in dataclasses.fields(port.DmaReadResult)]
            == [f.name for f in dataclasses.fields(jax_kernels.DmaReadResult)])
    r = port.dma_read_bandwidth_gbps(device="cpu")
    # the reference's host clamp: 1 MB -> one 256-row chunk
    assert r.bytes_read == 256 * 1024 * 4
    assert set(r.to_dict()) == {"bytes_read", "time_s", "gbps"}
    assert r.gbps > 0
