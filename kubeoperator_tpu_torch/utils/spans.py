"""Named ranges of the port's work, for `torch.profiler` traces.

`span(name)` is a `torch.profiler.record_function` range named
``"ko." + name`` while a profiler records, and one shared null context
otherwise: with no profiler on, a span costs one attribute read. The
ranges land in the profiler's trace beside the device activity, so each
kernel can be put down to the span that launched it (forward) or that
launched the forward op its backward node belongs to (backward, through
autograd's sequence numbers).
"""

from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler

# every span the port records, with its "ko." prefix: the entry's step,
# each model's blocks and AdamW; the expert layer's parts inside
# ko.block.ffn and the head at the top level (`workloads/mla_moe.py`)
SPANS = ("ko.train.step", "ko.block.attention", "ko.block.ffn",
         "ko.step.optimizer", "ko.moe.route", "ko.moe.experts",
         "ko.moe.combine", "ko.moe.shared", "ko.model.head")

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range ``"ko." + name`` while a profiler records, else a
    shared null context."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function("ko." + name)
    return _OFF
