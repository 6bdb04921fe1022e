"""The port's bench twin (`kubeoperator_tpu_torch/bench.py`) against the
root `bench.py`: the refusal line, the `details` key set of the 1-rank
branch (the heavy sweeps stubbed, the registries patched to a known part,
as tests/test_ops.py does for the reference), the >= 2-rank branch on 2
gloo ranks with the real psum and ring-attention gates and the real
workload sweep, `prior_run_comparison` on the same record files, and the
NVLink envelope both the bench and the harness read."""

import contextlib
import importlib.util
import io
import json
import os
from types import SimpleNamespace

import jax
import pytest

import kubeoperator_tpu.ops.collectives as jax_coll
import kubeoperator_tpu.ops.hbm as jax_hbm
import kubeoperator_tpu.ops.longcontext_check as jax_lcc
import kubeoperator_tpu.ops.matmul as jax_matmul
import kubeoperator_tpu.ops.pallas_kernels as jax_pallas
import kubeoperator_tpu.ops.train_smoke as jax_train
import kubeoperator_tpu.parallel.topology as jax_topo
from kubeoperator_tpu_torch import bench as pbench
from kubeoperator_tpu_torch.parallel import topology as ptopo
from kubeoperator_tpu_torch.parallel.multislice import initialize_from_env
from kubeoperator_tpu_torch.workloads import harness as ph

import chip_smoke
from tests.test_torch_ops import spawn_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = "NVIDIA H100 80GB HBM3"


def _load_reference():
    spec = importlib.util.spec_from_file_location(
        "bench_reference", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _line(fn, *args) -> tuple[int, dict]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


def _fake_mxu(size, **_):
    tflops = {2048: 700.0, 4096: 820.0, 8192: 810.0}[size]
    return SimpleNamespace(tflops=tflops, tflops_band=(tflops - 10, tflops + 10),
                           band_pct=20 / tflops * 100)


_FAKE_TRAIN = {"steps_per_s": 2.0, "ok": True, "model_tflops_per_s": 500.0,
               "mfu_pct": 50.0}


def test_unknown_device_is_refused_like_the_reference(monkeypatch):
    initialize_from_env("cpu")
    rc, got = _line(pbench.main, ["--cpu"])
    assert rc == 1
    ref_bench = _load_reference()
    monkeypatch.setattr(jax_topo, "generation_for_device", lambda dev: None)
    ref_rc, want = _line(ref_bench.main)
    assert ref_rc == rc
    assert got["metric"] == "error_no_gpu_visible"
    assert want["metric"] == "error_no_tpu_visible"
    assert {k: v for k, v in got.items() if k != "metric"} \
        == {k: v for k, v in want.items() if k != "metric"}
    assert got["details"] == {"device_kind": "cpu"}


def _reference_one_device(monkeypatch):
    """The reference's main on one of the virtual devices, as a v5e, its
    sweeps stubbed."""
    ref_bench = _load_reference()
    one = jax.devices()[:1]
    monkeypatch.setattr(jax, "devices", lambda *a: one)
    monkeypatch.setattr(jax_topo, "generation_for_device",
                        lambda dev: jax_topo.GENERATIONS["v5e"])
    monkeypatch.setattr(jax_matmul, "mxu_matmul_tflops", _fake_mxu)
    monkeypatch.setattr(jax_hbm, "hbm_bandwidth_gbps",
                        lambda **kw: SimpleNamespace(gbps=700.0))
    monkeypatch.setattr(jax_pallas, "dma_read_bandwidth_gbps",
                        lambda: SimpleNamespace(gbps=650.0))
    monkeypatch.setattr(jax_train, "run_train_smoke", lambda **kw: _FAKE_TRAIN)
    return ref_bench.main


def test_single_card_details_are_the_references(monkeypatch):
    rc, want = _line(_reference_one_device(monkeypatch))
    assert rc == 0
    monkeypatch.undo()
    # the port on the host as an H100: the matmul sweep and the BENCH_CONFIG
    # run stubbed; the triad, K1's read stream and the 4-step train smoke
    # run for real at their host sizes
    initialize_from_env("cpu")
    monkeypatch.setattr(pbench, "generation_for_device",
                        lambda dev: ptopo.GENERATIONS["h100-sxm"])
    monkeypatch.setattr(pbench, "mxu_matmul_tflops", _fake_mxu)
    real_train = pbench.run_train_smoke
    monkeypatch.setattr(
        pbench, "run_train_smoke",
        lambda cfg=None, **kw: real_train(**kw) if cfg is None else _FAKE_TRAIN)
    rc, got = _line(pbench.main, ["--cpu"])
    assert rc == 0
    assert got["metric"] == "h100-sxm_single_chip_mxu_bf16_tflops"
    assert want["metric"] == "v5e_single_chip_mxu_bf16_tflops"
    assert got["unit"] == want["unit"] == "TFLOP/s"
    assert got["value"] == want["value"] == 820.0
    assert got["vs_baseline"] == round(820.0 / 989.0, 3)
    d = got["details"]
    assert set(d) == set(want["details"]) - {"prior_run"}
    assert set(d) == chip_smoke.BENCH_N1_KEYS     # what phase 14 checks
    assert "prior_run" not in d     # every record in the repo is a TPU run
    assert d["device_kind"] == "cpu" and d["generation"] == "h100-sxm"
    for key in ("mxu_tflops_4096", "mxu_band_4096", "mxu_headline_band",
                "mxu_headline_band_pct", "mxu_band_blowout"):
        assert d[key] == want["details"][key], key
    assert isinstance(d["dma_read_gbps"], float) and d["dma_read_gbps"] > 0
    assert d["hbm_datasheet_gbps"] == 3350.0
    assert d["train_smoke_ok"] is True and d["train_bench_ok"] is True
    assert d["train_mfu_pct"] == 50.0


# ------------------------------------------------------ 2 gloo ranks ----
_RANK_SCRIPT = """
import contextlib, io, json, os
from types import SimpleNamespace
import torch.distributed as dist
from kubeoperator_tpu_torch import bench
from kubeoperator_tpu_torch.parallel import topology
from kubeoperator_tpu_torch.parallel.multislice import initialize_from_env
initialize_from_env("cpu")
bench.generation_for_device = lambda dev: topology.GENERATIONS["h100-sxm"]
bench.bench_collective = lambda op, size_mb, mesh, iters: SimpleNamespace(
    busbw_gbps=70.0 + size_mb)
bench.bench_ring_attention = lambda **kw: SimpleNamespace(
    to_dict=lambda: {"tflops": 9.9})
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    rc = bench.main(["--cpu"])
print("RANK_RESULT " + json.dumps(
    {"rank": dist.get_rank(), "rc": rc, "out": buf.getvalue()}), flush=True)
dist.barrier()
os._exit(0)
"""


def _reference_multi_device(monkeypatch) -> dict:
    """The reference's >= 2-device line on the 8 virtual devices, as in
    tests/test_ops.py: a v5e, the busbw sweep and the ring-attention rate
    stubbed, the gates and the workload sweep real."""
    ref_bench = _load_reference()
    monkeypatch.setattr(jax_topo, "generation_for_device",
                        lambda dev: jax_topo.GENERATIONS["v5e"])
    monkeypatch.setattr(jax_coll, "bench_collective",
                        lambda op, size_mb, mesh, iters: SimpleNamespace(
                            busbw_gbps=70.0 + size_mb))
    monkeypatch.setattr(jax_lcc, "bench_ring_attention",
                        lambda **kw: SimpleNamespace(to_dict=lambda: {"tflops": 9.9}))
    rc, line = _line(ref_bench.main)
    assert rc == 0
    return line


def test_multi_rank_branch_on_two_ranks(monkeypatch):
    want = _reference_multi_device(monkeypatch)
    ranks = spawn_ranks(2, _RANK_SCRIPT, timeout=300)
    assert [r["rc"] for r in ranks] == [0, 0]
    assert ranks[1]["out"] == ""            # rank 0 alone prints the line
    got = json.loads(ranks[0]["out"])
    assert got["metric"] == want["metric"] == "psum_allreduce_busbw_gbps"
    assert got["unit"] == want["unit"] == "GB/s"
    assert got["value"] == want["value"] == 134.0   # the best sweep point
    # over one NVLink direction of the whole card, not a per-link figure
    assert got["vs_baseline"] == round(134.0 / 450.0, 3)
    d = got["details"]
    assert set(d) == set(want["details"]) - {"prior_run"}
    assert d["devices"] == 2 and d["generation"] == "h100-sxm"
    assert d["psum_correct"] is True                 # real gate, 2 ranks
    assert d["ring_attention_correct"] is True       # real gate, 2 ranks
    assert d["ring_attention_tflops"] == 9.9
    assert d["workload_sweep_ok"] is True and d["workload_rows"]
    assert set(d["workload_rows"][0]) == set(want["details"]["workload_rows"][0])
    for size in (8, 32, 64):
        key = f"psum_busbw_{size}mb"
        assert d[key] == want["details"][key], key


def test_nvlink_envelope_is_the_cards_aggregate(monkeypatch, capsys):
    # the harness quotes the same envelope as the bench's vs_baseline
    assert ptopo.GENERATIONS["h100-sxm"].nvlink_gbps_per_gpu == 450.0
    initialize_from_env("cpu")
    monkeypatch.setattr(ptopo, "generation_for_device",
                        lambda dev: ptopo.GENERATIONS["h100-sxm"])
    assert ph.main(["--cpu"]) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("KO_TPU_WORKLOAD_RESULT ")]
    report = json.loads(line[0].split(" ", 1)[1])
    assert report["ici_envelope_gbps"] == 450.0
    assert report["peak_tflops_per_chip"] == 989.0


# --------------------------------------------- prior_run_comparison ----
def _write(tmp_path, name: str, parsed) -> None:
    (tmp_path / name).write_text(
        parsed if isinstance(parsed, str) else json.dumps({"parsed": parsed}))


def test_prior_run_matches_the_reference_on_the_same_device(tmp_path):
    ref_bench = _load_reference()
    metric = "h100-sxm_single_chip_mxu_bf16_tflops"
    _write(tmp_path, "BENCH_r01.json", {"metric": "x", "value": 1.0,
                                        "details": {"device_kind": H100}})
    _write(tmp_path, "BENCH_r03.json", {
        "metric": metric, "value": 800.0,
        "details": {"device_kind": H100, "hbm_triad_gbps": 3000.0,
                    "train_mfu_pct": 40.0,
                    "mxu_headline_protocol": "an older estimator"}})
    result = {"metric": metric, "value": 784.0,
              "details": {"device_kind": H100, "hbm_triad_gbps": 3030.0,
                          "train_mfu_pct": 40.0}}
    for value in (784.0, 796.0):        # a 2% drop is flagged, 0.5% is not
        result["value"] = value
        got = pbench.prior_run_comparison(result, here=str(tmp_path))
        assert got == ref_bench.prior_run_comparison(result, here=str(tmp_path))
        assert got["file"] == "BENCH_r03.json"
        assert got["headline_watch"] is (value == 784.0)
    assert got["detail_delta_pct"] == {"hbm_triad_gbps": 1.0, "train_mfu_pct": 0.0}
    # a change of headline estimator is noted, and never flagged
    result["details"]["mxu_headline_protocol"] = "median of 7 wide-span differential draws"
    result["value"] = 700.0
    got = pbench.prior_run_comparison(result, here=str(tmp_path))
    assert got == ref_bench.prior_run_comparison(result, here=str(tmp_path))
    assert "headline_delta_note" in got and got["headline_watch"] is False
    # a crashed newest round and garbage are skipped, as by the reference
    _write(tmp_path, "BENCH_r04.json", {})
    _write(tmp_path, "BENCH_r05.json", "[not json}")
    got = pbench.prior_run_comparison(result, here=str(tmp_path))
    assert got == ref_bench.prior_run_comparison(result, here=str(tmp_path))
    assert got["file"] == "BENCH_r03.json"
    assert pbench.prior_run_comparison(result, here=str(tmp_path / "x")) is None


def test_prior_run_skips_another_devices_records(tmp_path):
    ref_bench = _load_reference()
    metric = "h100-sxm_single_chip_mxu_bf16_tflops"
    _write(tmp_path, "BENCH_r02.json", {"metric": metric, "value": 800.0,
                                        "details": {"device_kind": H100}})
    _write(tmp_path, "BENCH_r03.json", {"metric": metric, "value": 190.0,
                                        "details": {"device_kind": "TPU v5 lite"}})
    result = {"metric": metric, "value": 790.0,
              "details": {"device_kind": H100}}
    # the reference reads the newest record whatever its device
    assert ref_bench.prior_run_comparison(result, here=str(tmp_path))["file"] \
        == "BENCH_r03.json"
    got = pbench.prior_run_comparison(result, here=str(tmp_path))
    assert got["file"] == "BENCH_r02.json" and got["headline_delta_pct"] == -1.25
    result["details"]["device_kind"] = "NVIDIA H100 NVL"
    assert pbench.prior_run_comparison(result, here=str(tmp_path)) is None
    # the repo's own records are TPU runs: none is this card's
    result["details"]["device_kind"] = H100
    assert pbench.prior_run_comparison(result) is None
