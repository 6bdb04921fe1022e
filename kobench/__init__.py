"""kobench: the benchmark of `kubeoperator_tpu_torch`, the PyTorch and CUDA
port of the platform's device path.

One run measures one cell of `BENCHMARK.json` (a model configuration under
a traffic mix) for a fixed window and prints one JSON line:

    python3 -m kobench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name `BENCHMARK.json` gives it
(`configs/`, `traffic/`, `metrics/`, `reference/`, `drivers/`). The
yardstick lives here: input generation, the frozen FLOP counts, the table
of peaks, the trace reduction and the plain references that decide
`correct`. Only the drivers import the port; nothing here imports JAX or
the JAX package.
"""
