"""Benchmark instruction sets (wide, bilingual).

The reference benchmarks fix small per-scene instruction lists in the benchmark
scripts (reference fsr_vln/application/visualize_query_graph/
visualize_query_graph_icra_ic4f.py:82-149 and the sh3f/ic3f/ic7f siblings,
which differ only in these lists); this module generates the equivalent
coverage programmatically for the synthetic fixtures: every object under
several phrasings (bare, imperative, room-qualified, floor-qualified) in
English and Chinese — ≥50 instructions for the three_room layout, matched to
query/parser.RuleParser's grammar.

The port's own copy of holoagent_tpu/eval/instruction_sets.py."""

from __future__ import annotations

from typing import Dict, List, Sequence

# objects per fixture room (dataloader/synthetic.py layouts)
THREE_ROOM_OBJECTS: Dict[str, Sequence[str]] = {
    "bedroom": ("bed", "chair"),
    "living room": ("sofa", "table"),
    "bathroom": ("toilet", "bathtub", "refrigerator"),
}

_ZH_OBJ = {
    "bed": "床", "chair": "椅子", "table": "桌子", "sofa": "沙发",
    "refrigerator": "冰箱", "toilet": "马桶", "bathtub": "浴缸",
}
_ZH_ROOM = {"bedroom": "卧室", "living room": "客厅", "bathroom": "浴室"}

_EN_TEMPLATES = (
    "find the {o}",
    "go to the {o}",
    "please locate the {o}",
    "take me to the {o} in the {r}",
    "find the {o} in the {r}",
    "{o} in region {r} on floor 1",
)
_ZH_TEMPLATES = (
    "找{zo}",
    "带我去{zo}",
    "在{zr}里找{zo}",
    "去一楼的{zr}找{zo}",
)


def three_room_instructions() -> List[str]:
    """>= 50 bilingual instructions over the three_room fixture."""
    out: List[str] = []
    for room, objs in THREE_ROOM_OBJECTS.items():
        for o in objs:
            zo, zr = _ZH_OBJ[o], _ZH_ROOM[room]
            for t in _EN_TEMPLATES:
                out.append(t.format(o=o, r=room))
            for t in _ZH_TEMPLATES:
                out.append(t.format(zo=zo, zr=zr))
    return out


def two_room_instructions() -> List[str]:
    objs = {"bedroom": ("bed", "chair", "table"),
            "living room": ("sofa", "refrigerator", "toilet")}
    out: List[str] = []
    for room, oo in objs.items():
        for o in oo:
            zo, zr = _ZH_OBJ[o], _ZH_ROOM.get(room, room)
            out.append(f"find the {o}")
            out.append(f"go to the {o} in the {room}")
            out.append(f"在{zr}里找{zo}")
    return out
