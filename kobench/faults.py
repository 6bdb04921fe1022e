"""Faults planted under a driver, to show that the comparison that decides
`correct` catches them. A benchmark run plants none; the tests and
`kobench.calibrate` do. Each is a context manager that breaks the port
in its module namespace and mends it on exit:

* ``unchanged``: the training step returns the state it was given;
* ``half_batch``: the step or forward sees only the first half of the
  batch rows, its mean taken over them;
* ``no_exchange``: the validation net's psum (the Megatron row-parallel
  sum and the loss's sum over ranks) returns its input unsummed;
* ``altered``: the first token of every sequence of every answer is
  replaced by its neighbour.
"""

from __future__ import annotations

import contextlib
import dataclasses


@contextlib.contextmanager
def _patched(module, name: str, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def _dense_train(fault: str):
    from kubeoperator_tpu_torch.workloads import harness

    make = harness.make_train_step

    def broken(mesh, cfg=None, *args, **kwargs):
        if fault == "half_batch":
            half = dataclasses.replace(cfg, b_local=cfg.b_local // 2)
            step, specs, used = make(mesh, half, *args, **kwargs)
            return (lambda state, x: step(state, x[: x.shape[0] // 2])), specs, used
        step, specs, used = make(mesh, cfg, *args, **kwargs)
        if fault == "unchanged":
            return (lambda state, x: (step(state, x)[0], state)), specs, used
        raise ValueError(f"no fault {fault!r} for the dense training step")

    return _patched(harness, "make_train_step", broken)


def _dense_serve(fault: str):
    from kubeoperator_tpu_torch.workloads import serve

    make = serve.make_forward

    def broken(mesh, cfg=None, *args, **kwargs):
        fn, specs, used = make(mesh, cfg, *args, **kwargs)
        if fault == "half_batch":
            return (lambda p, x: fn(p, x[: x.shape[0] // 2])), specs, used
        if fault == "altered":
            def altered(p, x):
                y = fn(p, x)
                y[:, 0] = y[:, 1]
                return y
            return altered, specs, used
        raise ValueError(f"no fault {fault!r} for the dense forward")

    return _patched(serve, "make_forward", broken)


def _vnet_train(fault: str):
    from kubeoperator_tpu_torch.parallel import validation_net as vnet

    if fault == "no_exchange":
        return _patched(vnet, "psum", lambda x, group: x)
    make = vnet.make_train_step

    def broken(mesh, lr=None, cfg=None):
        if fault == "half_batch":
            half = dataclasses.replace(cfg, b_local=cfg.b_local // 2)
            step = make(mesh, lr, half)
            return lambda params, x: step(params, x[: x.shape[0] // 2])
        step = make(mesh, lr, cfg)
        if fault == "unchanged":
            return lambda params, x: (step(params, x)[0], params)
        raise ValueError(f"no fault {fault!r} for the validation net")

    return _patched(vnet, "make_train_step", broken)


PLANTERS = {"train_dense": _dense_train, "serve_dense": _dense_serve,
            "train_vnet": _vnet_train}


def plant(driver: str, fault: str | None):
    """A context that breaks the program under `driver` by `fault`; a
    no-op for None."""
    if fault is None:
        return contextlib.nullcontext()
    return PLANTERS[driver](fault)
