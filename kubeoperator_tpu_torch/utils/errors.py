"""Typed errors with stable codes.

A copy of the part of `kubeoperator_tpu/utils/errors.py` the device path
raises, with the same ``code`` values so API and i18n layers that key off
them read the port's errors the same way.
"""

from __future__ import annotations


class KoError(Exception):
    """Base error: stable code + args for i18n interpolation."""

    code = "ERR_INTERNAL"
    http_status = 500

    def __init__(self, message: str = "", **args: object) -> None:
        self.args_map = dict(args)
        self.message = message or self.code
        super().__init__(self.message)

    def to_dict(self) -> dict:
        return {"code": self.code, "message": self.message, "args": self.args_map}


class ValidationError(KoError):
    code = "ERR_VALIDATION"
    http_status = 400


class TopologyError(ValidationError):
    """Invalid device topology / mesh-shape mismatch."""

    code = "ERR_TPU_TOPOLOGY"
