"""The precision of the reference's matrix products.

Every product of the reference towers goes through ``mm``.  By default it
is a float32 product (TF32 off).  Inside ``lowered("int4")`` both
operands are first rounded to the integers -7..7, the left one with a
scale per row and the right one with a scale per column (each slice's
largest magnitude at 7), and the product is taken in float32: the
reference one precision step below int8, which a W8A8 cell's control puts
in the program's place.
"""

from __future__ import annotations

import contextlib

import torch

_mode = ["float32"]


def _int4(x: torch.Tensor, dim: int) -> torch.Tensor:
    s = torch.clamp(x.abs().amax(dim=dim, keepdim=True), min=1e-12) / 7.0
    return torch.clamp(torch.round(x / s), -7.0, 7.0) * s


ROUNDINGS = {"int4": _int4}


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    rnd = ROUNDINGS.get(_mode[0])
    if rnd is not None:
        return rnd(a, -1) @ rnd(b, -2)
    return a @ b


@contextlib.contextmanager
def lowered(mode: str):
    if mode != "float32" and mode not in ROUNDINGS:
        raise ValueError(f"unknown precision {mode!r}")
    prev, _mode[0] = _mode[0], mode
    try:
        yield
    finally:
        _mode[0] = prev
