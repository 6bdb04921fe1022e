"""ID and time helpers (a copy of `kubeoperator_tpu/utils/ids.py`'s
`new_id` and `now_ts`)."""

from __future__ import annotations

import time
import uuid


def new_id() -> str:
    """Random UUID4 string."""
    return str(uuid.uuid4())


def now_ts() -> float:
    """Wall-clock seconds; single definition so tests can monkeypatch."""
    return time.time()
