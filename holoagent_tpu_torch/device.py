"""Device selection for the port.

Entry points (``Mapper``, the tower constructors, ``init_*``) run on the
card unless the caller passes ``device="cpu"``.  When CUDA is absent and the
caller did not ask for the CPU they raise: the port never carries on quietly
on the CPU.

Numerics: a float32 convolution goes through cuDNN in TF32 by default, which
keeps about three decimal digits.  The reference computes its float32 work
in full float32 (SAM's neck 3x3 convolution, the backprojection pose product
at ``Precision.HIGHEST``, the feature-fusion sums), so ``resolve`` turns TF32
off for both cuBLAS matmuls and cuDNN.  These are process-wide PyTorch
switches; bf16 tower matmuls are unaffected.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def disable_tf32() -> None:
    """Keep float32 matmuls and convolutions in full float32 (parity)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless asked otherwise.

    Raises when CUDA is requested (explicitly or by default) but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    disable_tf32()
    return dev


def dtype_of(name: str) -> torch.dtype:
    """Config dtype string -> torch dtype."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def upload(a, device: torch.device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A host array as a tensor on `device`, without waiting for the card:
    to a CUDA device it goes from pinned memory with ``non_blocking`` (a
    plain ``torch.as_tensor(a, device="cuda")`` synchronises the stream,
    which would drain a pipeline of queued device work)."""
    t = torch.as_tensor(a, dtype=dtype)
    if device.type != "cuda" or t.is_cuda:
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def generator(seed: int) -> torch.Generator:
    """Seeded CPU generator for random init (values are drawn on the CPU and
    moved, so a seed gives the same weights on every device)."""
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    return g
