"""kubeoperator_tpu's device path on PyTorch and CUDA (NVIDIA Hopper).

A port of the node-side validation workloads of `kubeoperator_tpu` (the
JAX package beside this one, which stays the reference). It imports
`torch` and nothing of JAX or of `kubeoperator_tpu`; what it needs from
framework-free reference modules is copied here.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; with no card and no explicit CPU request they raise.
Hand-written kernels live in `csrc/` and are compiled by `ops/_build.py`
at first use.
"""

__version__ = "0.1.0"
