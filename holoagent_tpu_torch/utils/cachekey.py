"""Machine-keyed cache paths (counterpart of holoagent_tpu/utils/cachekey.py).

The port's on-disk caches (the fixture-tower zoo, ``training/zoo.py``, and
the correctness suite's work directory, ``apps/correctness_suite.py``) live
under ``cache_root()`` (the temporary directory, ``$TMPDIR``), in a
directory keyed by a hash of the host CPU's feature flags, torch's version
and the Python minor version, and, on the card, the device's name: towers
trained on one machine, library or card are never served to another under
the same key.  Each user takes its own directory as its one override.
"""

from __future__ import annotations

import hashlib
import os
import platform
import tempfile

import torch

from ..device import DeviceLike, resolve


def machine_key(device: DeviceLike = "cpu") -> str:
    """Short stable hash of (CPU feature flags, torch version, python minor,
    and the CUDA device's name when `device` is the card)."""
    feats = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    feats = " ".join(sorted(line.split(":", 1)[1].split()))
                    break
    except OSError:
        feats = platform.processor() or platform.machine()
    py = ".".join(platform.python_version_tuple()[:2])
    dev = resolve(device)
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return hashlib.sha1(f"{feats}|torch {torch.__version__}|{py}|{card}".encode()).hexdigest()[:12]


def cache_root() -> str:
    """The port's temporary cache root, ``<tempfile.gettempdir()>/holoagent_tpu_torch``."""
    return os.path.join(tempfile.gettempdir(), "holoagent_tpu_torch")


def machine_cache_dir(name: str, device: DeviceLike = "cpu") -> str:
    """Per-machine cache directory ``<cache_root()>/<name>-<machine_key>``."""
    path = os.path.join(cache_root(), f"{name}-{machine_key(device)}")
    os.makedirs(path, exist_ok=True)
    return path
