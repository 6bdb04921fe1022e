"""The trace reduction on a synthetic trace: busy time is the union of
intervals across streams, kernel classes, the busy share of spans, and
idle gaps named by the host op that launched the kernel after them."""

import pytest

from kobench import trace
from kobench.trace import DeviceEvent, HostEvent


def _trace():
    # stream 7: a product 0-100 and an add 150-200; stream 9: NCCL 50-160,
    # overlapping both; then nothing until a copy at 300-310. Thread 1
    # launches the product (an mm inside a matmul) and the add, thread 2
    # (autograd's) the copy; the add's launch on thread 1 lies inside an mm
    # of thread 2, which must not make it a product
    device = [DeviceEvent("nvjet_gemm", 0, 100, 7, 1),
              DeviceEvent("ncclDevKernel_AllReduce", 50, 160, 9, 2),
              DeviceEvent("elementwise_add", 150, 200, 7, 3),
              DeviceEvent("copy_kernel", 300, 310, 7, 4)]
    host = [HostEvent("aten::matmul", 0, 25, 0, False, 1),
            HostEvent("aten::mm", 1, 20, 0, False, 1, 1000.0),
            HostEvent("cudaLaunchKernel", 5, 6, 1, True, 1),
            HostEvent("aten::add", 140, 150, 0, False, 1),
            HostEvent("cudaLaunchKernel", 141, 142, 3, True, 1),
            HostEvent("aten::mm", 130, 145, 0, False, 2, 500.0),
            HostEvent("aten::copy_", 280, 299, 0, False, 2),
            HostEvent("cudaMemcpyAsync", 290, 291, 4, True, 2)]
    return device, host


def test_busy_is_the_union_across_streams():
    s = trace.summarize(*_trace())
    assert s["busy_s"] == pytest.approx(210e-9)      # 0-200 and 300-310
    assert s["kernel_s"] == pytest.approx(270e-9)    # the plain sum
    assert s["nccl_s"] == pytest.approx(110e-9)
    assert s["matmul_s"] == pytest.approx(100e-9)
    assert s["matmul_flops"] == 1500.0
    assert s["other_s"] == pytest.approx(60e-9)


def test_idle_gaps_name_the_host_op_that_ended_them():
    s = trace.summarize(*_trace())
    assert s["idle_gaps"] == [["aten::copy_", pytest.approx(100e-9)]]
    assert s["device_ops"][0] == ["ncclDevKernel_AllReduce", pytest.approx(110e-9)]


def test_busy_share_of_spans():
    device, host = _trace()
    s = trace.summarize(device, host, spans=[(90, 250), (180, 320)])
    assert s["span_s"] == pytest.approx(230e-9)          # 90-320
    assert s["busy_in_spans_s"] == pytest.approx(120e-9)  # 90-200, 300-310


def test_ranks_merge_by_summing():
    one = trace.summarize(*_trace())
    both = trace.merge_ranks([one, one])
    assert both["ranks"] == 2
    assert both["busy_s"] == pytest.approx(2 * one["busy_s"])
    assert both["device_ops"][0][1] == pytest.approx(220e-9)


def test_union_merges_touching_and_nested():
    assert trace.union([(5, 6), (0, 4), (4, 5), (1, 2)]) == [(0, 6)]


class _Kineto:
    """The part of a kineto event that `trace._kind` reads."""

    def __init__(self, name, device, annotated=False, correlation=0):
        self._name, self._device = name, device
        self._annotated, self._correlation = annotated, correlation

    def name(self):
        return self._name

    def device_type(self):
        return f"DeviceType.{self._device}"

    def is_user_annotation(self):
        return self._annotated

    def correlation_id(self):
        return self._correlation


@pytest.mark.parametrize("event, kind", [
    (_Kineto("nvjet_gemm", "CUDA", correlation=3), "device"),
    (_Kineto("kobench.request", "CUDA", annotated=True), ""),
    (_Kineto("ProfilerStep#1", "CUDA", annotated=True), ""),
    (_Kineto("kobench.request", "CPU", annotated=True), "span"),
    (_Kineto("ProfilerStep#1", "CPU", annotated=True), ""),
    (_Kineto("cudaLaunchKernel", "CPU", correlation=3), "launch"),
    (_Kineto("cuLaunchKernelEx", "CPU", correlation=4), "launch"),
    (_Kineto("cudaGetDevice", "CPU"), "op"),
    (_Kineto("aten::mm", "CPU"), "op"),
])
def test_events_are_classed_by_device_name_and_annotation(event, kind):
    """A `record_function` range drawn on the device is no device work:
    counted, it would cover the whole request."""
    assert trace._kind(event, "kobench.request") == kind
