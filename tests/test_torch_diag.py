"""The port's `koctl tpu diag` against the JAX package's report: the same
single-device keys, the same memory_health block, the same honesty
guards, and the same multi-device branch."""

import json
import os
from types import SimpleNamespace

import torch.distributed as dist

import kubeoperator_tpu.parallel.topology as jax_topology
from kubeoperator_tpu import ops as jax_ops
from kubeoperator_tpu.cli import koctl as jax_koctl
from kubeoperator_tpu_torch import ops as port_ops
from kubeoperator_tpu_torch.cli import koctl as port_koctl
from kubeoperator_tpu_torch.parallel.topology import GENERATIONS

# keys the reference adds only with 2 or more devices
MULTI_DEVICE_KEYS = {"collectives", "ring_all_gather_correct", "pallas_ring",
                     "ring_attention_correct", "ring_attention"}
PORT_ARGS = ["tpu", "diag", "--cpu", "--size", "64", "--iters", "2"]


def _fake(**fields):
    return SimpleNamespace(to_dict=lambda: dict(fields))


def _jax_report(monkeypatch, capsys, gen=None) -> dict:
    """The reference's report with its heavy benches stubbed, as
    tests/test_api_cli.py does."""
    monkeypatch.setattr(jax_ops, "mxu_matmul_tflops", lambda **kw: _fake(tflops=1.0))
    monkeypatch.setattr(jax_ops, "hbm_bandwidth_gbps", lambda **kw: _fake(gbps=2.0))
    monkeypatch.setattr(jax_ops, "dma_read_bandwidth_gbps", lambda **kw: _fake(gbps=3.0))
    monkeypatch.setattr(jax_ops, "run_collective_suite", lambda **kw: [])
    monkeypatch.setattr(jax_ops, "verify_ring_all_gather", lambda **kw: True)
    monkeypatch.setattr(jax_ops, "bench_ring_all_gather", lambda **kw: _fake())
    monkeypatch.setattr(jax_ops, "verify_ring_attention", lambda **kw: True)
    monkeypatch.setattr(jax_ops, "bench_ring_attention", lambda **kw: _fake())
    if gen is not None:
        monkeypatch.setattr(jax_topology, "generation_for_device", lambda d: gen)
    assert jax_koctl.main(["tpu", "diag"]) == 0
    return json.loads(capsys.readouterr().out)


def _port_report(capsys, args=PORT_ARGS) -> dict:
    assert port_koctl.main(args) == 0
    return json.loads(capsys.readouterr().out)


def test_single_device_keys_match_reference(monkeypatch, capsys):
    ref = _jax_report(monkeypatch, capsys)
    port = _port_report(capsys)
    assert set(ref) - MULTI_DEVICE_KEYS - {"not_a_tpu"} \
        == set(port) - {"not_a_known_gpu"}
    assert port["devices"] == 1 and port["device_kind"] == "cpu"
    assert "not_a_known_gpu" in port and "memory_health" not in port
    assert "suspect_short_window" not in port["mxu"]
    for key in ("hbm_triad", "dma_read"):
        assert port[key]["gbps"] > 0


def test_memory_health_block_matches_reference(monkeypatch, capsys):
    ref = _jax_report(monkeypatch, capsys, gen=jax_topology.GENERATIONS["v5e"])
    monkeypatch.setattr(port_koctl, "generation_for_device",
                        lambda d: GENERATIONS["h100-sxm"])
    port = _port_report(capsys)
    assert set(port) == set(ref) - MULTI_DEVICE_KEYS
    assert list(port["memory_health"]) == list(ref["memory_health"])
    health = port["memory_health"]
    assert health["datasheet_gbps"] == 3350.0
    assert health["dma_vs_datasheet"] == round(health["dma_peak_gbps"] / 3350.0, 3)


def test_impossible_readings_are_flagged(monkeypatch, capsys):
    monkeypatch.setattr(port_koctl, "generation_for_device",
                        lambda d: GENERATIONS["h100-sxm"])
    monkeypatch.setattr(port_ops, "mxu_matmul_tflops",
                        lambda **kw: _fake(tflops=1200.0))
    monkeypatch.setattr(port_ops, "hbm_bandwidth_gbps",
                        lambda **kw: _fake(gbps=9000.0))
    monkeypatch.setattr(port_ops, "dma_read_bandwidth_gbps",
                        lambda **kw: _fake(gbps=2900.0))
    port = _port_report(capsys)
    assert "suspect_short_window" in port["mxu"]
    assert "suspect_short_window" in port["hbm_triad"]
    assert "suspect_short_window" not in port["dma_read"]


def test_profile_dir_writes_a_trace(capsys, tmp_path):
    port = _port_report(capsys, PORT_ARGS + ["--profile-dir", str(tmp_path)])
    assert port["profile_dir"] == str(tmp_path)
    assert os.path.getsize(tmp_path / "trace.json") > 0


def test_two_ranks_run_the_suite_then_refuse_the_ring(monkeypatch, capsys):
    # the multi-device branch used to refuse after the suite; it now runs
    # the reference's five steps in its order and reports its key set
    ref = _jax_report(monkeypatch, capsys)
    ran = []

    def step(name, value):
        def fn(**kw):
            ran.append((name, kw))
            return value
        return fn

    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(port_ops, "run_collective_suite",
                        step("collectives", []))
    monkeypatch.setattr(port_ops, "verify_ring_all_gather",
                        step("verify_ring_all_gather", True))
    monkeypatch.setattr(port_ops, "bench_ring_all_gather",
                        step("bench_ring_all_gather", _fake(busbw_gbps=1.0)))
    monkeypatch.setattr(port_ops, "verify_ring_attention",
                        step("verify_ring_attention", True))
    monkeypatch.setattr(port_ops, "bench_ring_attention",
                        step("bench_ring_attention", _fake(tflops=1.0)))
    port = _port_report(capsys)
    assert [name for name, _ in ran] == [
        "collectives", "verify_ring_all_gather", "bench_ring_all_gather",
        "verify_ring_attention", "bench_ring_attention"]
    assert ran[-1][1] == {"seq_per_device": 256, "iters": 4}
    assert port["devices"] == 2
    assert set(port) - {"not_a_known_gpu"} == set(ref) - {"not_a_tpu"}
    assert MULTI_DEVICE_KEYS <= set(port)
    assert port["ring_all_gather_correct"] is True
    assert port["ring_attention_correct"] is True
