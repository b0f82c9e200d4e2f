"""Seeded tower weights, made on the device.

A tower's parameter spec (name -> shape, kind, scale; ``reference.sam.spec``,
``reference.clip.visual_spec``, ``text_spec``) is filled from one normal
draw on the card's generator, in the order of the spec, and each value is
rounded once to the dtype it is served in.  The program's modules are
loaded from these tensors, and the reference takes the same tensors in
float32, so both compute with the same numbers.  The same seed gives the
same weights.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

Spec = Dict[str, Tuple[tuple, str, float]]


def make(spec: Spec, seed: int, dtype_of: Callable[[str], torch.dtype], device) -> Dict[str, torch.Tensor]:
    """name -> tensor in ``dtype_of(name)`` on `device`.  One generator
    call draws every normal value; each parameter is a scaled slice."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & (2**63 - 1))
    sizes = [int(torch.Size(shape).numel()) if kind == "normal" else 0 for shape, kind, _ in spec.values()]
    draw = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for (name, (shape, kind, scale)), n in zip(spec.items(), sizes):
        if kind == "normal":
            val = (draw[off : off + n] * scale).reshape(shape)
            off += n
        else:
            val = torch.full(shape, scale, device=device)
        out[name] = val.to(dtype_of(name))
    return out


def load_into(module: torch.nn.Module, values: Dict[str, torch.Tensor]) -> None:
    """Copy `values` into the module's parameters of the same names; the
    names, shapes and dtypes must match the spec exactly."""
    params = dict(module.named_parameters())
    if set(params) != set(values):
        missing, extra = sorted(set(values) - set(params)), sorted(set(params) - set(values))
        raise ValueError(f"the program's parameters differ from the spec: missing {missing[:5]}, extra {extra[:5]}")
    with torch.no_grad():
        for name, p in params.items():
            v = values[name]
            if p.shape != v.shape or p.dtype != v.dtype:
                raise ValueError(f"{name}: program {tuple(p.shape)} {p.dtype}, spec {tuple(v.shape)} {v.dtype}")
            p.copy_(v)


def as_float32(values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.float() for k, v in values.items()}
