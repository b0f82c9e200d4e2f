"""What the kernel A/B scripts (scripts/k2_ab.py, scripts/k3_ab.py) share:
the builds to compare, the order they are timed in, and the card's name.
Each build is timed in turns A, B, ..., B, A and keeps its faster turn, so a
drift of the card's clock over the call weighs on every build alike."""

from __future__ import annotations

import subprocess
from pathlib import Path


def variants(source: Path, argv: list[str], flags: dict | None = None) -> dict[str, str]:
    """The source as it stands ("source"), then each `name=path.cu` of argv.
    `flags` maps a command-line flag to {name: (old, new)}: each name is the
    source with the line `old` replaced by `new`."""
    text = source.read_text()
    out = {"source": text}
    for arg in argv:
        if flags and arg in flags:
            for name, (old, new) in flags[arg].items():
                if old not in text:
                    raise SystemExit(f"{arg} {name}: the source no longer has the line it patches")
                out[name] = text.replace(old, new)
        elif "=" in arg:
            name, path = arg.split("=", 1)
            out[name] = Path(path).read_text()
        else:
            raise SystemExit(f"unknown argument {arg!r}: give name=path.cu")
    return out


def best_of_turns(names: list[str], measure) -> dict[str, float]:
    """Each name's least `measure(name)` (ms) over the turns A, B, ..., B, A."""
    ms: dict[str, float] = {}
    for name in names + names[::-1]:
        ms[name] = min(ms.get(name, float("inf")), measure(name))
    return ms


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
