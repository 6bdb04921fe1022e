"""The Kimi-K2 cell and the bursty serve cell at sizes the CPU runs: the
configuration states its cut, the frozen counts are the port's, the
benchmark's reference copy is the port's steps in float32, the check
catches the control and the planted faults, a traced run names the
expert layer's spans and reads its metrics, and the bursty stream offers
the rate its traffic file states."""

import json

import pytest
import torch

from kobench import compare, flops_mla, harness
from kobench.drivers import serve_dense_burst, train_mla_moe
from kobench.tests.conftest import REPO, TINY, copy_bench

SEED = 2 ** 31 + 23
CELL = "kimi-k2-train-8k"
SMALL = {"hidden_size": 64, "num_attention_heads": 4, "q_lora_rank": 32,
         "kv_lora_rank": 16, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
         "v_head_dim": 16, "intermediate_size": 96, "moe_intermediate_size": 24,
         "num_experts_per_tok": 4, "n_routed_experts": 4, "vocab_size": 64,
         "num_hidden_layers": 3, "b_local": 2, "s_local": 16,
         "init_scale": 0.1}


def _small_root(tmp_path, **extra):
    root = copy_bench(tmp_path, TINY)
    path = root / "kobench/configs/kimi-k2-ep48.json"
    cfg = json.loads(path.read_text())
    cfg.update(SMALL, **extra)
    cfg["deployment"] = dict(cfg["deployment"], router_width=16,
                             experts_held=[0, 1, 2, 3])
    path.write_text(json.dumps(cfg))
    return root


def test_the_configuration_states_its_cut():
    cfg = json.loads((REPO / "kobench/configs/kimi-k2-ep48.json").read_text())
    dep, pub = cfg["deployment"], cfg["published"]
    assert cfg["reduced"] == ["n_routed_experts", "vocab_size", "num_hidden_layers"]
    assert cfg["n_routed_experts"] == len(dep["experts_held"]) == 8
    assert dep["router_width"] == pub["n_routed_experts"] == 384
    assert dep["router_width"] // cfg["n_routed_experts"] == dep["expert_parallel"] == 48
    assert dep["nodes"] * dep["cards_per_node"] == 48
    assert pub["vocab_size"] // cfg["vocab_size"] == 8
    assert cfg["first_k_dense_replace"] == 1 and cfg["num_hidden_layers"] == 5
    # every width as published
    assert (cfg["hidden_size"], cfg["num_attention_heads"], cfg["q_lora_rank"],
            cfg["kv_lora_rank"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
            cfg["v_head_dim"], cfg["intermediate_size"],
            cfg["moe_intermediate_size"], cfg["num_experts_per_tok"]) == (
        7168, 64, 1536, 512, 128, 64, 128, 18432, 2048, 8)


@pytest.mark.parametrize("small", [False, True])
def test_the_frozen_counts_are_the_ports(tmp_path, small):
    from kubeoperator_tpu_torch.workloads.mla_moe import step_flops

    root = _small_root(tmp_path) if small else REPO
    cfg = harness.load_cell(root, CELL).config
    port = train_mla_moe.model_config(cfg)
    assert flops_mla.step_flops(cfg) == step_flops(port, cfg["b_local"] * cfg["s_local"])
    if not small:
        # the causal half of q·kᵀ (192) and P·v (128) forward, two of each
        # back, 5 layers of 3 rows of 8192 tokens at 64 heads
        assert flops_mla.k3_operations(cfg) == 5 * 3 * (3 * 64 * 8192 * 8193) * 320


def test_the_reference_copy_is_the_ports_adamw_steps(tmp_path):
    cell = harness.load_cell(_small_root(tmp_path, dtype="float32"), CELL)
    _, prog = train_mla_moe.program_run(cell, SEED, 0.0, False, "cpu")
    ref = train_mla_moe.reference_outputs(cell, SEED, torch.device("cpu"))
    got = compare.train_readings(prog, ref)
    # float32 both ways: the same function, summed in other orders; AdamW's
    # near-sign first steps leave the change within 1e-3
    assert max(v for k, v in got.items() if not k.startswith("change")) < 2e-4, got
    assert got["change_gap"] < 1e-3, got


def test_the_control_and_the_planted_faults_are_not_correct(tmp_path):
    cell = harness.load_cell(_small_root(tmp_path), CELL)
    drv = harness.driver(cell)
    limits = cell.traffic["limits"]
    assert not harness.passed(harness.checks(drv.control(cell, SEED, "cpu"), limits))
    for fault in ("half_batch", "unchanged"):
        out = drv.run(cell, SEED, 0.2, False, "cpu", fault)
        assert not harness.result(cell, out, False, 1.0)["correct"], fault


def test_a_traced_run_names_the_expert_spans_and_reads_the_counter(tmp_path):
    cell = harness.load_cell(_small_root(tmp_path), CELL)
    outcome = harness.driver(cell).run(cell, SEED, 0.3, True, "cpu")
    line = harness.result(cell, outcome, True, 1.0)
    found = outcome["layer"]["spans"]["spans"]
    steps = outcome["layer"]["steps"]
    assert {"ko.moe.route", "ko.moe.experts", "ko.moe.combine", "ko.moe.shared",
            "ko.model.head"} <= set(found)
    # routing, then the gather once the counts are read: two ranges a layer
    assert found["ko.moe.route"]["count"] == 2 * 2 * steps
    loads = outcome["layer"]["expert_loads"]
    # every routed slot of every window step, 2 MoE layers x 4 held experts
    assert len(loads) == 2 and all(len(c) == 4 for c in loads)
    assert line["metrics"]["expert_load_max_over_mean"]["value"] >= 1
    # a CPU run has no K3 kernels and no device time
    assert "mla_attention_roofline" not in line["metrics"]
    assert "moe_experts_ms_per_step" not in line["metrics"]


def test_the_bursty_stream_offers_its_rates():
    tr = json.loads((REPO / "kobench/traffic/dense-serve-burst.json").read_text())
    due = serve_dense_burst.arrivals(tr, 25.0)
    assert [(a, b) for a, b, r in serve_dense_burst.phases(tr, 25.0) if r > 12.5] \
        == [(2, 4), (12, 14), (22, 24)]
    for a, b in ((2, 4), (12, 14), (22, 24)):
        assert ((due >= a) & (due < b)).sum() == 75          # 3 x 12.5 for 2 s
    assert ((due >= 4) & (due < 12)).sum() == 50             # 0.5 x 12.5 for 8 s
    # a 10 s period offers the mean rate
    assert ((due >= 2) & (due < 12)).sum() == 125
    assert (serve_dense_burst.arrivals(tr, 25.0) == due).all()


def test_the_bursty_cell_runs_the_serve_window(tmp_path):
    root = copy_bench(tmp_path, TINY)
    cell = harness.load_cell(root, "dense-serve-burst")
    out = harness.driver(cell).run(cell, SEED, 0.5, False, "cpu")
    assert harness.result(cell, out, False, 1.0)["correct"]
    assert out["attempted"] == len(serve_dense_burst.arrivals(cell.traffic, 0.5))
