"""Error codes and exceptions (counterpart of ``scann_tpu/errors.py``):
the gRPC/absl-style error-code surface as a Python exception hierarchy."""

from __future__ import annotations

import enum


class ErrorCode(enum.Enum):
    """gRPC-style status codes."""

    OK = "OK"
    CANCELLED = "CANCELLED"
    UNKNOWN = "UNKNOWN"
    INVALID_ARGUMENT = "INVALID_ARGUMENT"
    DEADLINE_EXCEEDED = "DEADLINE_EXCEEDED"
    NOT_FOUND = "NOT_FOUND"
    ALREADY_EXISTS = "ALREADY_EXISTS"
    PERMISSION_DENIED = "PERMISSION_DENIED"
    RESOURCE_EXHAUSTED = "RESOURCE_EXHAUSTED"
    FAILED_PRECONDITION = "FAILED_PRECONDITION"
    ABORTED = "ABORTED"
    OUT_OF_RANGE = "OUT_OF_RANGE"
    UNIMPLEMENTED = "UNIMPLEMENTED"
    INTERNAL = "INTERNAL"
    UNAVAILABLE = "UNAVAILABLE"
    DATA_LOSS = "DATA_LOSS"
    UNAUTHENTICATED = "UNAUTHENTICATED"


class ScannError(Exception):
    """Base error carrying an :class:`ErrorCode`."""

    def __init__(self, code: ErrorCode, message: str):
        self.code = code
        self.message = message
        super().__init__(f"{code.value}: {message}")

    @classmethod
    def invalid_argument(cls, message: str) -> "ScannError":
        return cls(ErrorCode.INVALID_ARGUMENT, message)

    @classmethod
    def not_found(cls, message: str) -> "ScannError":
        return cls(ErrorCode.NOT_FOUND, message)

    @classmethod
    def already_exists(cls, message: str) -> "ScannError":
        return cls(ErrorCode.ALREADY_EXISTS, message)

    @classmethod
    def failed_precondition(cls, message: str) -> "ScannError":
        return cls(ErrorCode.FAILED_PRECONDITION, message)

    @classmethod
    def out_of_range(cls, message: str) -> "ScannError":
        return cls(ErrorCode.OUT_OF_RANGE, message)

    @classmethod
    def unimplemented(cls, message: str) -> "ScannError":
        return cls(ErrorCode.UNIMPLEMENTED, message)

    @classmethod
    def internal(cls, message: str) -> "ScannError":
        return cls(ErrorCode.INTERNAL, message)

    @classmethod
    def resource_exhausted(cls, message: str) -> "ScannError":
        return cls(ErrorCode.RESOURCE_EXHAUSTED, message)
