"""The port's spans (`kubeoperator_tpu_torch/utils/spans.py`): free with no
profiler on, recorded once a step where the training entry does its work
when one is, tied to the backward through autograd's sequence numbers, and
without effect on any computed value."""

import torch

from kubeoperator_tpu_torch.parallel.mesh import MeshSpec
from kubeoperator_tpu_torch.parallel.multislice import initialize_from_env
from kubeoperator_tpu_torch.parallel.validation_net import NetConfig
from kubeoperator_tpu_torch.utils import spans
from kubeoperator_tpu_torch.workloads import harness

TINY = NetConfig(d_model=32, d_ff=64, heads=4, b_local=2, s_local=8,
                 dtype="float32")
STEPS = 2


def _run(profiled: bool):
    initialize_from_env("cpu")
    mesh = MeshSpec.parse("data=1,fsdp=1,tp=1").build("cpu")
    if not profiled:
        return harness.run_training(mesh, TINY, steps=STEPS, return_state=True), []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run = harness.run_training(mesh, TINY, steps=STEPS, return_state=True)
    return run, list(prof.profiler.kineto_results.events())


def test_with_the_profiler_off_a_span_is_the_shared_null_context(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler on")

    monkeypatch.setattr(spans._profiler, "record_function", refuse)
    first = spans.span("train.step")
    assert first is spans.span("block.ffn") is spans._OFF
    with first:
        pass


def test_the_vocabulary_is_prefixed():
    assert all(name.startswith("ko.") for name in spans.SPANS)
    assert len(set(spans.SPANS)) == len(spans.SPANS)


def _ranges(events) -> list:
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                    e.start_thread_id()) for e in events
                   if e.is_user_annotation() and e.name().startswith("ko.")),
                  key=lambda r: r[1])


# the spans of the dense stage's step; the expert layer's and the head's
# are the Kimi-K2 block's (tests/test_torch_mla_moe.py)
DENSE = ("ko.train.step", "ko.block.attention", "ko.block.ffn",
         "ko.step.optimizer")


def test_a_profiled_run_records_each_span_once_a_step():
    _, events = _run(profiled=True)
    ranges = _ranges(events)
    counts = {name: sum(r[0] == name for r in ranges) for name in spans.SPANS}
    assert counts == {name: STEPS if name in DENSE else 0
                      for name in spans.SPANS}
    assert {r[0] for r in ranges} <= set(spans.SPANS)
    steps = [r for r in ranges if r[0] == "ko.train.step"]
    for name in DENSE[1:]:
        inner = [r for r in ranges if r[0] == name]
        for step, r in zip(steps, inner):      # one of each inside each step
            assert step[1] <= r[1] and r[2] <= step[2] and r[3] == step[3]


def test_backward_nodes_point_at_forward_ops_inside_the_blocks():
    _, events = _run(profiled=True)
    blocks = [r for r in _ranges(events) if r[0].startswith("ko.block.")]
    forward = {}
    for e in events:
        if e.sequence_nr() >= 0 and not e.fwd_thread_id() \
                and not e.is_user_annotation():
            forward.setdefault((e.start_thread_id(), e.sequence_nr()), []).append(e)
    hit = set()
    nodes = [e for e in events if "Backward" in e.name()
             and e.sequence_nr() >= 0 and e.fwd_thread_id() > 0]
    assert nodes
    for node in nodes:
        ops = forward.get((node.fwd_thread_id(), node.sequence_nr()))
        assert ops, node.name()
        for op in ops:
            for i, (_, start, end, thread) in enumerate(blocks):
                if thread == op.start_thread_id() and start <= op.start_ns() <= end:
                    hit.add(i)
    # every block range of every step holds a forward op some node differentiates
    assert hit == set(range(len(blocks))) and len(blocks) == 2 * STEPS


def test_profiled_and_unprofiled_runs_are_bit_equal():
    plain, _ = _run(profiled=False)
    traced, _ = _run(profiled=True)
    assert plain["losses"] == traced["losses"]
    a, b = plain["state"], traced["state"]
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    for moments in ("mu", "nu"):
        for k, t in getattr(a["opt"][0], moments).items():
            assert torch.equal(t, getattr(b["opt"][0], moments)[k]), (moments, k)
    assert torch.equal(a["opt"][0].count, b["opt"][0].count)
