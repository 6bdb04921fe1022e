"""The device seams of the control plane (port of the device calls in
`kubeoperator_tpu/service/workload.py`, `service/queue.py` and
`resilience/slicepool.py`).

* `workload` — `visible_devices`, `mesh_axes`, `run_training`,
  `run_serving` and `run_sweep` with the reference's keywords, in the
  caller's process at one rank and through the callback relay at k;
* `relay` — the relay: k rank processes whose callbacks fire in the
  caller's process, boundary by boundary;
* `drills` — the device half of the reference's preemption, queue and
  serving chaos soaks (`koctl chaos-soak`).

The services themselves (journal, queue decisions, checkpoint index) stay
control-plane code of the JAX package and are not ported; tests inject
these functions into them.
"""
