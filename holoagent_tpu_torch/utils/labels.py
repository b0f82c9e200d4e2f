"""Label vocabularies + cached CLIP text features.

The port's own copy of holoagent_tpu/utils/labels.py: the built-in
vocabularies, the room types and their object affinities, file
vocabularies under ``labels_dir``, and the same ``.npy`` cache layout.  Not
copied: the vocabularies of the reference's ``vocab_data.json`` data asset
and ``FIXTURE`` (the trained fixture towers' classes); asking for one raises
``KeyError`` (ROADMAP.md).

Capability parity with the reference's label_feats module
(reference fsr_vln/memory/hmsg/utils/label_feats.py:11-126: per-vocabulary
CLIP text-feature .npy caches) and its constants
(reference fsr_vln/memory/hmsg/utils/constants.py — the ScanNet-20 benchmark
labels and the room-type list used for room naming).  Large vocabularies
(ScanNet-200, COCO-Stuff, Matterport) load from CSV/JSON files supplied by the
user, same formats the reference ships.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from ..models.clip import text_features_multi_template

# ScanNet benchmark 20-class vocabulary (public benchmark labels) + background,
# the reference's SCANNET_LABELS_20 (constants.py:9-31)
SCANNET_LABELS_20: Tuple[str, ...] = (
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "picture", "counter", "desk", "curtain",
    "refrigerator", "shower curtain", "toilet", "sink", "bathtub",
    "furniture", "background",
)

# room-type vocabulary used for room naming (cf. DEFAULT_ROOM_TYPES usage at
# reference graph.py:2146-2187 / room.py:237-307)
DEFAULT_ROOM_TYPES: Tuple[str, ...] = (
    "living room", "bedroom", "kitchen", "bathroom", "dining room", "office",
    "hallway", "closet", "laundry room", "garage", "balcony", "meeting room",
    "lobby", "corridor", "storage room", "stairwell", "library",
)

# Object-name -> room-type affinities: the offline stand-in for the world
# knowledge the reference's LLM room-typing mode queries GPT for
# (reference fsr_vln/memory/hmsg/utils/llm_utils.py
# `infer_room_type_from_object_list_chat`, room.py:237-307 "label" mode asks
# "what kind of room contains these objects?").  Standard indoor priors only
# — an object listed under k types contributes 1/k of a vote to each (a sink
# is kitchen-or-bathroom evidence, a toilet is bathroom evidence).  Objects
# not listed carry no room-type information and abstain.
OBJECT_ROOM_AFFINITY: Dict[str, Tuple[str, ...]] = {
    "bed": ("bedroom",),
    "wardrobe": ("bedroom",),
    "nightstand": ("bedroom",),
    "dresser": ("bedroom",),
    "sofa": ("living room",),
    "couch": ("living room",),
    "coffee table": ("living room",),
    "piano": ("living room", "library"),
    "tv": ("living room", "bedroom"),
    "fireplace": ("living room",),
    "refrigerator": ("kitchen",),
    "oven": ("kitchen",),
    "stove": ("kitchen",),
    "microwave": ("kitchen",),
    "dishwasher": ("kitchen",),
    "kitchen cabinet": ("kitchen",),
    "counter": ("kitchen",),
    "sink": ("kitchen", "bathroom"),
    "bathtub": ("bathroom",),
    "toilet": ("bathroom",),
    "shower": ("bathroom",),
    "towel": ("bathroom",),
    "desk": ("office",),
    "computer": ("office",),
    "monitor": ("office",),
    "keyboard": ("office",),
    "office chair": ("office",),
    "bookshelf": ("library", "office"),
    "book": ("library",),
    "dining table": ("dining room",),
    "washing machine": ("laundry room",),
    "gym equipment": ("gym",),
    "stairs": ("stairwell",),
}

# ScanNet-200 benchmark vocabulary (public benchmark category names; the
# reference's SCANNET_200 role, labels/label_constants.py / constants.py).
SCANNET_LABELS_200: Tuple[str, ...] = (
    "wall", "chair", "floor", "table", "door", "couch", "cabinet", "shelf",
    "desk", "office chair", "bed", "pillow", "sink", "picture", "window",
    "toilet", "bookshelf", "monitor", "curtain", "book", "armchair",
    "coffee table", "box", "refrigerator", "lamp", "kitchen cabinet", "towel",
    "clothes", "tv", "nightstand", "counter", "dresser", "stool", "cushion",
    "plant", "ceiling", "bathtub", "end table", "dining table", "keyboard",
    "bag", "backpack", "toilet paper", "printer", "tv stand", "whiteboard",
    "blanket", "shower curtain", "trash can", "closet", "stairs", "microwave",
    "stove", "shoe", "computer tower", "bottle", "bin", "ottoman", "bench",
    "board", "washing machine", "mirror", "copier", "basket", "sofa chair",
    "file cabinet", "fan", "laptop", "shower", "paper", "person",
    "paper towel dispenser", "oven", "blinds", "rack", "plate", "blackboard",
    "piano", "suitcase", "rail", "radiator", "recycling bin", "container",
    "wardrobe", "soap dispenser", "telephone", "bucket", "clock", "stand",
    "light", "laundry basket", "pipe", "clothes dryer", "guitar",
    "toilet paper holder", "seat", "speaker", "column", "bicycle", "ladder",
    "bathroom stall", "shower wall", "cup", "jacket", "storage bin",
    "coffee maker", "dishwasher", "paper towel roll", "machine", "mat",
    "windowsill", "bar", "toaster", "bulletin board", "ironing board",
    "fireplace", "soap dish", "kitchen counter", "doorframe",
    "toilet paper dispenser", "mini fridge", "fire extinguisher", "ball",
    "hat", "shower curtain rod", "water cooler", "paper cutter", "tray",
    "shower door", "pillar", "ledge", "toaster oven", "mouse",
    "toilet seat cover dispenser", "furniture", "cart", "storage container",
    "scale", "tissue box", "light switch", "crate", "power outlet",
    "decoration", "sign", "projector", "closet door", "vacuum cleaner",
    "candle", "plunger", "stuffed animal", "headphones", "dish rack", "broom",
    "guitar case", "range hood", "dustpan", "hair dryer", "water bottle",
    "handicap bar", "purse", "vent", "shower floor", "water pitcher",
    "mailbox", "bowl", "paper bag", "alarm clock", "music stand",
    "projector screen", "divider", "laundry detergent", "bathroom counter",
    "object", "bathroom vanity", "closet wall", "laundry hamper",
    "bathroom stall door", "ceiling light", "trash bin", "dumbbell",
    "stair rail", "tube", "bathroom cabinet", "cd case", "closet rod",
    "coffee kettle", "structure", "shower head", "keyboard piano",
    "case of water bottles", "coat rack", "storage organizer", "folded chair",
    "fire alarm", "power strip", "calendar", "poster", "potted plant",
    "luggage", "mattress",
)

# Matterport mpcat40 category set (public Matterport3D metadata; the
# reference's MATTERPORT_LABELS_40 role, utils/label_feats.py Matterport
# vocabularies)
MATTERPORT_LABELS_40: Tuple[str, ...] = (
    "wall", "floor", "chair", "door", "table", "picture", "cabinet",
    "cushion", "window", "sofa", "bed", "curtain", "chest of drawers",
    "plant", "sink", "stairs", "ceiling", "toilet", "stool", "towel",
    "mirror", "tv monitor", "shower", "column", "bathtub", "counter",
    "fireplace", "lighting", "beam", "railing", "shelving", "blinds",
    "gym equipment", "seating", "board panel", "furniture", "appliances",
    "clothes", "objects", "misc",
)

# Common HM3DSem navigation-relevant categories (HM3D semantic annotations
# vocabulary head; the reference's HM3D label role)
HM3D_LABELS: Tuple[str, ...] = (
    "wall", "floor", "ceiling", "door", "window", "chair", "table", "couch",
    "bed", "cabinet", "shelf", "lamp", "plant", "pillow", "curtain", "mirror",
    "picture", "rug", "towel", "sink", "toilet", "bathtub", "shower",
    "refrigerator", "oven", "microwave", "stove", "dishwasher", "tv",
    "stairs", "railing", "counter", "desk", "wardrobe", "nightstand",
    "dresser", "bench", "stool", "ottoman", "fireplace", "washing machine",
    "clothes", "box", "book", "bottle", "cup", "vase", "basket", "bag",
    "trash can",
)

_BUILTIN: Dict[str, Tuple[str, ...]] = {
    "SCANNET20": SCANNET_LABELS_20,
    "SCANNET200": SCANNET_LABELS_200,
    "MATTERPORT40": MATTERPORT_LABELS_40,
    "HM3D": HM3D_LABELS,
    "ROOM_TYPES": DEFAULT_ROOM_TYPES,
}


def load_vocabulary(
    name: str, labels_dir: Optional[str | Path] = None
) -> Tuple[str, ...]:
    """Resolve a vocabulary by name: built-ins first, else
    `<labels_dir>/<name>.txt|.json|.csv` (one label per line / json list /
    csv first col)."""
    if name.upper() in _BUILTIN:
        return _BUILTIN[name.upper()]
    if labels_dir is None:
        raise KeyError(
            f"unknown vocabulary {name!r}; built-ins: {sorted(_BUILTIN)}; "
            "pass labels_dir for file-based vocabularies (the data-asset "
            "vocabularies are not ported, ROADMAP.md)"
        )
    base = Path(labels_dir)
    for ext in (".txt", ".json", ".csv"):
        p = base / f"{name}{ext}"
        if p.exists():
            if ext == ".json":
                return tuple(json.loads(p.read_text()))
            if ext == ".csv":
                return tuple(
                    line.split(",")[0].strip()
                    for line in p.read_text().splitlines()[1:]
                    if line.strip()
                )
            return tuple(l.strip() for l in p.read_text().splitlines() if l.strip())
    raise FileNotFoundError(f"no vocabulary file for {name!r} under {base}")


def get_label_feats(
    text,
    tokenizer,
    vocab_name: str,
    cache_dir: Optional[str | Path] = None,
    labels_dir: Optional[str | Path] = None,
) -> Tuple[np.ndarray, Tuple[str, ...]]:
    """(text_feats (C, D) float32 L2-normalized, classes) with .npy caching
    (reference label_feats.py:17-34 cache layout: `<cache>/<vocab>_<model>.npy`).
    `text` is the CLIP text tower (``models.clip.CLIPText``); the cache is
    named after its variant."""
    variant = text.variant
    classes = load_vocabulary(vocab_name, labels_dir)
    cache_file = None
    if cache_dir is not None:
        cache_file = Path(cache_dir) / f"{vocab_name}_{variant.name}.npy"
        if cache_file.exists():
            feats = np.load(cache_file)
            if feats.shape == (len(classes), variant.embed_dim):
                return feats, classes
    feats = text_features_multi_template(text, tokenizer, list(classes)).cpu().numpy()
    if cache_file is not None:
        cache_file.parent.mkdir(parents=True, exist_ok=True)
        np.save(cache_file, feats)
    return feats, classes
