"""The port's Ready gate against the JAX package's: both KO_TPU_SMOKE_RESULT
lines go through adm/phases.py (parse_marker_json, smoke_post) to the
same verdict."""

import contextlib
import io
import json

import pytest

from kubeoperator_tpu.adm.phases import SMOKE_MARKER, parse_marker_json, smoke_post
from kubeoperator_tpu.ops import psum_smoke as jax_smoke
from kubeoperator_tpu.utils.errors import PhaseError
from kubeoperator_tpu_torch.ops import psum_smoke as port_smoke

from tests.test_adm import make_ctx


def _marker_line(main, capsys, *args) -> str:
    assert main(*args) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith(SMOKE_MARKER)]
    assert len(lines) == 1
    return lines[0]


@pytest.fixture(scope="module")
def both_lines():
    """(port line, JAX line) from each package's main(), run once."""
    mp = pytest.MonkeyPatch()
    mp.delenv("KO_TPU_EXPECTED_CHIPS", raising=False)
    mp.delenv("KO_TPU_TRAIN_STEPS", raising=False)
    lines = []
    try:
        for main, args in ((port_smoke.main, ("cpu",)), (jax_smoke.main, ())):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert main(*args) == 0
            lines.append([ln for ln in buf.getvalue().splitlines()
                          if ln.startswith(SMOKE_MARKER)][0])
    finally:
        mp.undo()
    return tuple(lines)


def _verdict(line: str, **ctx_kw) -> str:
    ctx = make_ctx(**ctx_kw)
    try:
        smoke_post(ctx, None, [line])
    except PhaseError as e:
        if "below threshold" in e.message:
            return "fail: threshold"
        if "expected" in e.message:
            return "fail: chip count"
        return "fail: " + e.message
    assert ctx.cluster.status.smoke_passed
    return "pass"


def test_lines_parse_to_the_same_keys(both_lines):
    port, ref = (parse_marker_json(SMOKE_MARKER, [ln]) for ln in both_lines)
    assert list(port) == list(ref)
    assert port["ok"] and ref["ok"] and port["correctness"]
    assert port["chips"] == 1 and port["num_processes"] == 1
    assert len(port["table"]) == len(ref["table"]) == 4


@pytest.mark.parametrize("ctx_kw, verdict", [
    ({}, "pass"),                                   # no plan: no chip count
    ({"smoke_test_gbps_threshold": 1e9}, "fail: threshold"),
    ({"tpu": True}, "fail: chip count"),            # v5e-16 plan wants 16
])
def test_smoke_post_gives_the_same_verdict(both_lines, ctx_kw, verdict):
    port, ref = both_lines
    assert _verdict(port, **ctx_kw) == _verdict(ref, **ctx_kw) == verdict


def test_chip_mismatch_fails_in_both(monkeypatch):
    monkeypatch.setenv("KO_TPU_EXPECTED_CHIPS", "16")
    port = port_smoke.run_smoke(sizes_mb=(0.1,), iters=2, device="cpu")
    ref = jax_smoke.run_smoke(sizes_mb=(0.1,), iters=2)
    for result in (port, ref):
        assert not result["ok"] and result["correctness"]
        assert result["expected_chips"] == 16


def test_train_steps_raise_not_implemented(monkeypatch):
    # named for the refusal the gate once gave KO_TPU_TRAIN_STEPS>0: it no
    # longer raises, but runs the train smoke and folds its verdict into
    # `ok` with the reference's keys
    monkeypatch.setenv("KO_TPU_TRAIN_STEPS", "2")
    port = port_smoke.run_smoke(sizes_mb=(0.1,), iters=2, device="cpu")
    ref = jax_smoke.run_smoke(sizes_mb=(0.1,), iters=2)
    assert list(port) == list(ref) and list(port)[-1] == "train"
    assert port["ok"] is port["train"]["ok"] is True
    assert len(port["train"]["losses"]) == 2


def test_main_prints_one_marker_line(monkeypatch, capsys):
    monkeypatch.setenv("KO_TPU_EXPECTED_CHIPS", "1")
    monkeypatch.setattr(port_smoke, "run_smoke",
                        lambda **kw: {"ok": True, "chips": 1, "gbps": 1.0})
    line = _marker_line(port_smoke.main, capsys, "cpu")
    assert json.loads(line.split(" ", 1)[1])["ok"] is True
