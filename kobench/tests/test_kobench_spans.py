"""The span attribution (`kobench/spans.py`) on a synthetic trace: forward
kernels by the range around their launch, backward kernels through the
sequence number of their node on a second thread, nesting, runtime-call
time and its blocked part, unclaimed time, idle gaps named by span and
host op; the four metrics that read it; and the cell's driver on the
CPU."""

import importlib.util
import json

import pytest

from kobench import harness, spans
from kobench.spans import Op, Range
from kobench.tests.conftest import REPO
from kobench.trace import DeviceEvent

METRICS = {"entry_host_ms_per_step": ("ko.train.step", "own_s"),
           "attention_ms_per_step": ("ko.block.attention", "device_s"),
           "ffn_ms_per_step": ("ko.block.ffn", "device_s"),
           "optimizer_ms_per_step": ("ko.step.optimizer", "device_s")}


def _trace():
    # thread 1 runs the step: attention 100-300 and the FFN 300-500 nested
    # in the step 0-1000, the readout's mul at 550, the optimizer 700-900;
    # a copy at 1490 lies outside every range. Thread 2 (autograd's) runs
    # the backward nodes of the FFN's mm (seq 20), attention's mm (seq 10)
    # and the readout's mul (seq 30). The profiler's own op just before the
    # attention range carries seq 10 too, and must not take it.
    ranges = [Range("ko.train.step", 0, 1000, 1),
              Range("ko.block.attention", 100, 300, 1),
              Range("ko.block.ffn", 300, 500, 1),
              Range("ko.step.optimizer", 700, 900, 1)]
    host = [Op("profiler::_record_function_enter_new", 95, 99, 0, False, 1, 10),
            Op("aten::mm", 110, 150, 0, False, 1, 10),
            Op("cudaLaunchKernel", 120, 121, 1, True, 1),
            Op("aten::mm", 310, 350, 0, False, 1, 20),
            Op("cudaLaunchKernel", 320, 321, 2, True, 1),
            Op("aten::mul", 550, 560, 0, False, 1, 30),
            Op("cudaLaunchKernel", 551, 552, 3, True, 1),
            Op("aten::add", 710, 720, 0, False, 1, 40),
            Op("cudaLaunchKernel", 711, 712, 4, True, 1),
            Op("aten::copy_", 1490, 1510, 0, False, 1),
            Op("cudaMemcpyAsync", 1500, 1501, 7, True, 1),
            Op("autograd::engine::evaluate_function: MmBackward0", 600, 660, 0,
               False, 2, 20, 1),
            Op("MmBackward0", 601, 659, 0, False, 2, 20, 1),
            Op("aten::mm", 605, 640, 0, False, 2),
            Op("cudaLaunchKernel", 610, 611, 5, True, 2),
            Op("MmBackward0", 661, 690, 0, False, 2, 10, 1),
            Op("cudaLaunchKernel", 670, 671, 6, True, 2),
            Op("MulBackward0", 691, 699, 0, False, 2, 30, 1),
            Op("cudaLaunchKernel", 695, 696, 8, True, 2)]
    device = [DeviceEvent("gemm_attn", 2000, 2100, 7, 1),
              DeviceEvent("gemm_ffn", 2100, 2300, 7, 2),
              DeviceEvent("mul", 2300, 2320, 7, 3),
              DeviceEvent("gemm_ffn_bwd", 2320, 2400, 7, 5),
              DeviceEvent("gemm_attn_bwd", 2400, 2500, 7, 6),
              DeviceEvent("mul_bwd", 2500, 2550, 7, 8),
              DeviceEvent("adam", 2600, 2650, 7, 4),
              DeviceEvent("copy", 3000, 3010, 7, 7)]
    return device, host, ranges


def test_forward_and_backward_kernels_go_to_their_block():
    s = spans.summarize(*_trace())["spans"]
    assert s["ko.block.attention"]["device_s"] == pytest.approx(200e-9)
    assert s["ko.block.ffn"]["device_s"] == pytest.approx(280e-9)
    assert s["ko.step.optimizer"]["device_s"] == pytest.approx(50e-9)


def test_a_span_holds_the_time_of_the_spans_nested_in_it():
    s = spans.summarize(*_trace())["spans"]
    # both blocks, their backward, the readout and its backward, AdamW
    assert s["ko.train.step"]["device_s"] == pytest.approx(600e-9)
    assert s["ko.train.step"]["host_s"] == pytest.approx(1000e-9)
    assert {k: v["count"] for k, v in s.items()} == {
        "ko.train.step": 1, "ko.block.attention": 1, "ko.block.ffn": 1,
        "ko.step.optimizer": 1}


def test_runtime_time_counts_the_calls_of_every_thread_inside_a_span():
    s = spans.summarize(*_trace())["spans"]
    # four launches of the calling thread and three of autograd's, 1 each;
    # the copy at 1500 is after the step
    assert s["ko.train.step"]["runtime_s"] == pytest.approx(7e-9)
    assert s["ko.block.attention"]["runtime_s"] == pytest.approx(1e-9)
    assert s["ko.step.optimizer"]["runtime_s"] == pytest.approx(1e-9)


def test_a_names_unblocked_cost_is_the_median_of_its_fast_calls():
    calls = [Op("cudaLaunchKernel", 0, ns, i, True, 1)
             for i, ns in enumerate([3, 5, 6, 7, 400, 900, 1500, 2000])]
    calls += [Op("cuLaunchKernelEx", 0, ns, 9, True, 1) for ns in (800, 8, 500)]
    # most launches of a name may wait: the waits lie beyond ten times the
    # fastest call and do not count
    assert spans.unblocked_cost(calls) == {"cudaLaunchKernel": 5,
                                           "cuLaunchKernelEx": 8}


def test_blocked_time_is_each_calls_excess_over_its_unblocked_cost():
    device, host, ranges = _trace()
    # the FFN's launch waits 50 for room in the queue, the optimizer's 30
    host = [h._replace(end_ns=h.start_ns + 51) if h.correlation == 2 else
            h._replace(end_ns=h.start_ns + 31) if h.correlation == 4 else h
            for h in host]
    s = spans.summarize(device, host, ranges)["spans"]
    assert s["ko.train.step"]["runtime_s"] == pytest.approx(87e-9)
    assert s["ko.train.step"]["blocked_s"] == pytest.approx(80e-9)
    assert s["ko.block.ffn"]["blocked_s"] == pytest.approx(50e-9)
    assert s["ko.block.attention"]["blocked_s"] == 0
    assert s["ko.step.optimizer"]["blocked_s"] == pytest.approx(30e-9)


def test_unclaimed_time_is_what_no_span_holds():
    out = spans.summarize(*_trace())
    assert out["busy_s"] == pytest.approx(610e-9)
    assert out["claimed_s"] == pytest.approx(600e-9)
    assert out["unclaimed_s"] == pytest.approx(10e-9)


def test_idle_gaps_are_named_by_span_and_host_op():
    out = spans.summarize(*_trace())
    assert out["idle_gaps"] == [["entry/aten::copy_", pytest.approx(350e-9)],
                                ["ko.step.optimizer/aten::add",
                                 pytest.approx(50e-9)]]


def test_a_trace_without_ranges_claims_nothing():
    device, host, _ = _trace()
    out = spans.summarize(device, host, [])
    assert out["spans"] == {} and out["unclaimed_s"] == pytest.approx(610e-9)
    assert all(name.startswith("entry/") for name, _ in out["idle_gaps"])


class _Kineto:
    def __init__(self, name, device, start, dur, annotated=False,
                 correlation=0, thread=1, seq=-1, fwd_thread=0):
        self.v = dict(name=name, device_type=f"DeviceType.{device}",
                      start_ns=start, duration_ns=dur,
                      is_user_annotation=annotated, correlation_id=correlation,
                      start_thread_id=thread, sequence_nr=seq,
                      fwd_thread_id=fwd_thread, device_resource_id=7)

    def __getattr__(self, key):
        return lambda: self.v[key]


def test_from_profiler_keeps_ranges_sequence_numbers_and_threads():
    events = [_Kineto("ko.block.ffn", "CPU", 10, 90, annotated=True),
              _Kineto("ko.block.ffn", "CUDA", 200, 50, annotated=True),
              _Kineto("MmBackward0", "CPU", 300, 20, thread=2, seq=5,
                      fwd_thread=1),
              _Kineto("cudaLaunchKernel", "CPU", 305, 2, correlation=9, thread=2),
              _Kineto("gemm", "CUDA", 400, 30, correlation=9)]

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return events

    device, host, ranges = spans.from_profiler(Prof)
    assert ranges == [Range("ko.block.ffn", 10, 100, 1)]
    assert device == [DeviceEvent("gemm", 400, 430, 7, 9)]
    assert host == [Op("MmBackward0", 300, 320, 0, False, 2, 5, 1),
                    Op("cudaLaunchKernel", 305, 307, 9, True, 2, -1, 0)]


def _reader(name):
    path = REPO / "kobench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", sorted(METRICS))
def test_each_metric_divides_its_span_by_the_steps(name):
    span, key = METRICS[name]
    module = _reader(name)
    summary = spans.summarize(*_trace())
    found = dict(summary["spans"][span])
    found["own_s"] = found["host_s"] - found["blocked_s"]
    assert module.SPAN == span
    value = module.read({"steps": 2, "spans": summary})
    assert value == pytest.approx(1e3 * found[key] / 2)
    assert module.read({"steps": 2, "spans": spans.summarize([], [], [])}) is None
    assert module.read({"steps": 2}) is None


def test_the_metrics_read_spans_the_port_records():
    from kubeoperator_tpu_torch.utils.spans import SPANS

    assert {_reader(name).SPAN for name in METRICS} <= set(SPANS)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["name"] in METRICS:
            assert m["workloads"] == ["dense-train-long"] and m["unit"] == "ms"


def test_the_cell_runs_traced_on_the_cpu_and_names_its_spans(tiny_root):
    cell = harness.load_cell(tiny_root, "dense-train-long")
    drv = harness.driver(cell)
    outcome = drv.run(cell, 2 ** 31 + 11, 0.3, True, "cpu")
    line = harness.result(cell, outcome, True, 1.0)
    assert line["correct"]
    found = outcome["layer"]["spans"]["spans"]
    steps = outcome["layer"]["steps"]
    assert {k: v["count"] for k, v in found.items()} == {
        "ko.train.step": steps, "ko.block.attention": steps,
        "ko.block.ffn": steps, "ko.step.optimizer": steps}
    # a CPU run has host time and no device time
    assert line["metrics"]["entry_host_ms_per_step"]["value"] > 0
    assert "attention_ms_per_step" not in line["metrics"]
    assert not harness.passed(harness.checks(drv.control(cell, 2 ** 31 + 11, "cpu"),
                                             cell.traffic["limits"]))
