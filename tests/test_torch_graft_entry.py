"""The port's graft entry (`kubeoperator_tpu_torch/graft_entry.py`) against
the root `__graft_entry__.py`: `entry()`'s inputs bit for bit, its block
against the JAX `_forward` on the same numpy inputs at a reduced block,
the (dp, pp, sp, tp) factorization, and `dryrun_multichip(4)` (4 gloo
ranks) against the reference's first training step on the same mesh.

Tolerances: the port rounds the block where XLA rounds the reference, so
the two bf16 outputs are equal but where an f32 sum taken in another
order lands on the other side of a bf16 rounding: at most 1% of the
entries may differ (0.04-0.3% do), each by at most one bf16 step of the
inputs' scale (2^-6 at |x| < 4) plus 2^-7 relative. A missed rounding
point or the exact gelu in place of the tanh one moves 3-15% of the
entries. The dry run's loss is f32 arithmetic in another summation
order: 1e-5 relative."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeoperator_tpu.parallel import validation_net as jvnet
from kubeoperator_tpu_torch import graft_entry as pg
from kubeoperator_tpu_torch.parallel import validation_net as pvnet

from tests.test_torch_ops import one_spawn_at_a_time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_TOL = 2e-2
BF16_UNEQUAL = 0.01
REDUCED = [dict(BATCH=2, SEQ=64, D_MODEL=256), dict(BATCH=1, SEQ=64, D_MODEL=512)]


def _load_reference(**constants):
    spec = importlib.util.spec_from_file_location(
        "graft_reference", os.path.join(REPO, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name, value in constants.items():
        setattr(mod, name, value)
    return mod


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def assert_bf16_agrees(got: torch.Tensor, want: torch.Tensor) -> None:
    """`got` is `want` in bf16 but for rounding ties (module docstring)."""
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    assert float((got != want).float().mean()) <= BF16_UNEQUAL
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=2 ** -6)


def test_entry_inputs_are_the_references_bit_for_bit():
    _, want = _load_reference().entry()
    fn, got = pg.entry("cpu")
    assert fn is pg._forward
    assert [tuple(t.shape) for t in got] == [a.shape for a in want]
    assert all(t.dtype == torch.bfloat16 and t.device.type == "cpu" for t in got)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    assert (pg.BATCH, pg.SEQ, pg.D_MODEL, pg.HEADS) == (4, 512, 1024, 8)


def test_entry_puts_its_args_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        pg.entry()


def test_block_matches_the_jax_forward_at_a_reduced_block():
    for shape in REDUCED:
        ref = _load_reference(**shape)
        _, args = ref.entry()
        want = np.array(jax.jit(ref._forward)(*args).astype(jnp.float32))
        got = pg._forward(*pg.block_inputs(*shape.values()))
        assert_bf16_agrees(got, torch.from_numpy(want).bfloat16())


def test_block_in_f32_stays_within_bf16_of_the_bf16_block():
    # the card's check (chip_smoke.py phase 15): the bf16 block against the
    # same fn on f32 copies of its inputs
    args = pg.block_inputs(2, 64, 256)
    got = pg._forward(*args).float()
    want = pg._forward(*(a.float() for a in args))
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("n", range(1, 9))
def test_axis_sizes_match_the_reference(n):
    assert pvnet.axis_sizes(n) == _load_reference()._axis_sizes(n)


def test_dryrun_on_four_ranks_matches_the_reference_step(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    with one_spawn_at_a_time():
        got = pg.dryrun_multichip(4)
    mesh = jvnet.build_mesh_for(jax.devices()[:4])
    params, x, _ = jvnet.build_params_and_batch(mesh)
    loss, _ = jvnet.make_train_step(mesh)(params, x)
    assert got["devices"] == 4 and got["device_type"] == "cpu"
    assert got["mesh"] == {"dp": 1, "pp": 1, "sp": 2, "tp": 2} \
        == {k: int(v) for k, v in mesh.shape.items()}
    np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)


def test_dryrun_on_cards_refuses_more_ranks_than_cards():
    if torch.cuda.device_count() >= 2:
        pytest.skip("this host has the cards")
    with pytest.raises(RuntimeError, match="one rank per card"):
        pg.dryrun_multichip(2, device="cuda")
