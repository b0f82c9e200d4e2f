"""HMSG node types: Floor, Room, View, Object.

The port's own copy of holoagent_tpu/memory/nodes.py, with the same
ply+json schema: a graph saved by either package loads in the other.

Artifact-compatible with the reference's ply+json persistence so a graph
built here can be consumed by tools written against the reference
(reference fsr_vln/memory/hmsg/graph/floor.py:33-69, room.py:309-374,
object.py:37-106, view.py:62-110 define the schemas; field names and file
layout match byte-for-byte in the JSON and o3d-compatible binary PLY)."""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..utils.ply import read_ply, write_ply


@dataclass(eq=False)
class Floor:
    floor_id: str
    name: Optional[str] = None
    rooms: List["Room"] = field(default_factory=list)
    pcd_points: Optional[np.ndarray] = None
    pcd_colors: Optional[np.ndarray] = None
    vertices: Optional[np.ndarray] = None  # 8 bbox corners
    floor_height: Optional[float] = None
    floor_zero_level: Optional[float] = None

    def add_room(self, room: "Room"):
        self.rooms.append(room)

    def save(self, path: str | Path):
        write_ply(Path(path) / f"{self.floor_id}.ply", self.pcd_points, self.pcd_colors)
        metadata = {
            "floor_id": self.floor_id,
            "name": self.name,
            "rooms": [r.room_id for r in self.rooms],
            "vertices": np.asarray(self.vertices).tolist(),
            "floor_height": float(self.floor_height),
            "floor_zero_level": float(self.floor_zero_level),
        }
        (Path(path) / f"{self.floor_id}.json").write_text(json.dumps(metadata))

    def load(self, path: str | Path):
        self.pcd_points, self.pcd_colors = read_ply(Path(path) / f"{self.floor_id}.ply")
        meta = json.loads((Path(path) / f"{self.floor_id}.json").read_text())
        self.name = meta["name"]
        self.vertices = np.asarray(meta["vertices"])
        self.floor_height = meta["floor_height"]
        self.floor_zero_level = meta["floor_zero_level"]
        return self


@dataclass(eq=False)
class Room:
    room_id: str
    floor_id: str
    name: Optional[str] = None
    objects: List["Object"] = field(default_factory=list)
    views: List["View"] = field(default_factory=list)
    pcd_points: Optional[np.ndarray] = None
    pcd_colors: Optional[np.ndarray] = None
    vertices: Optional[np.ndarray] = None  # (N, 2) footprint points
    room_height: Optional[float] = None
    room_zero_level: Optional[float] = None
    embeddings: List[np.ndarray] = field(default_factory=list)  # representative view embs
    represent_images: List[int] = field(default_factory=list)
    sample_images: List[int] = field(default_factory=list)
    clip_embeddings: List[np.ndarray] = field(default_factory=list)  # all member view embs
    object_counter: int = 0

    def add_object(self, obj: "Object"):
        self.objects.append(obj)

    def save(self, path: str | Path):
        write_ply(Path(path) / f"{self.room_id}.ply", self.pcd_points, self.pcd_colors)
        metadata = {
            "room_id": self.room_id,
            "name": self.name,
            "floor_id": self.floor_id,
            "objects": [o.object_id for o in self.objects],
            "views": [v.view_id for v in self.views],
            "vertices": np.asarray(self.vertices).tolist(),
            "room_height": float(self.room_height),
            "room_zero_level": float(self.room_zero_level),
            "embeddings": [np.asarray(e).tolist() for e in self.embeddings],
            "represent_images": [int(i) for i in self.represent_images],
            "sample_images": [int(i) for i in self.sample_images],
            "clip_embeddings": [np.asarray(e).tolist() for e in self.clip_embeddings],
        }
        (Path(path) / f"{self.room_id}.json").write_text(json.dumps(metadata))

    def load(self, path: str | Path):
        self.pcd_points, self.pcd_colors = read_ply(Path(path) / f"{self.room_id}.ply")
        meta = json.loads((Path(path) / f"{self.room_id}.json").read_text())
        self.name = meta["name"]
        self.floor_id = meta["floor_id"]
        self.vertices = np.asarray(meta["vertices"])
        self.room_height = meta["room_height"]
        self.room_zero_level = meta["room_zero_level"]
        self.embeddings = [np.asarray(e, np.float32) for e in meta["embeddings"]]
        self.represent_images = meta["represent_images"]
        self.sample_images = meta["sample_images"]
        self.clip_embeddings = [np.asarray(e, np.float32) for e in meta["clip_embeddings"]]
        self._view_ids = meta.get("views", [])
        return self


@dataclass(eq=False)
class Object:
    object_id: str
    room_id: str
    name: Optional[str] = None
    gt_name: Optional[str] = None
    pcd_points: Optional[np.ndarray] = None
    pcd_colors: Optional[np.ndarray] = None
    vertices: Optional[np.ndarray] = None  # (N, 2) footprint
    embedding: Optional[np.ndarray] = None
    best_view_id: Optional[str] = None
    view_ids: List[str] = field(default_factory=list)

    def center(self) -> np.ndarray:
        """Component-wise MEDIAN of the object cloud.  The reference takes
        `obj_pcd.get_center()` (mean, graph.py:3012) — but only after every
        mask cloud has been DBSCAN-denoised (graph.py:1464,1590), which
        strips the floor/wall bleed points a raw mean would be dragged by.
        The median is the O(n) robust equivalent of denoise-then-mean."""
        return np.median(np.asarray(self.pcd_points), axis=0)

    def save(self, path: str | Path):
        write_ply(Path(path) / f"{self.object_id}.ply", self.pcd_points, self.pcd_colors)
        metadata = {
            "object_id": self.object_id,
            "vertices": np.asarray(self.vertices).tolist(),
            "room_id": self.room_id,
            "name": self.name,
            "embedding": np.asarray(self.embedding).tolist()
            if self.embedding is not None
            else "",
            "view_ids": list(self.view_ids),
            "best_view_id": self.best_view_id,
        }
        (Path(path) / f"{self.object_id}.json").write_text(json.dumps(metadata))

    def load(self, path: str | Path):
        self.pcd_points, self.pcd_colors = read_ply(Path(path) / f"{self.object_id}.ply")
        meta = json.loads((Path(path) / f"{self.object_id}.json").read_text())
        self.vertices = np.asarray(meta["vertices"])
        self.room_id = meta["room_id"]
        self.name = meta["name"]
        self.embedding = (
            np.asarray(meta["embedding"], np.float32) if meta["embedding"] != "" else None
        )
        self.view_ids = meta.get("view_ids", [])
        self.best_view_id = meta.get("best_view_id")
        return self


@dataclass(eq=False)
class View:
    view_id: str
    room_id: str
    img_id: Optional[int] = None
    name: Optional[str] = None
    img_path: Optional[str] = None
    embedding: Optional[np.ndarray] = None
    object_ids: List[str] = field(default_factory=list)
    text_discription: List[str] = field(default_factory=list)  # sic (schema parity)

    def add_object(self, object_id: str):
        self.object_ids.append(object_id)

    def save(self, path: str | Path):
        metadata = {
            "view_id": self.view_id,
            "room_id": self.room_id,
            "img_id": int(self.img_id) if self.img_id is not None else None,
            "object_ids": list(self.object_ids),
            "img_path": self.img_path,
            "text_discription": [str(x) for x in self.text_discription],
        }
        (Path(path) / f"{self.view_id}.json").write_text(json.dumps(metadata))

    def load(self, path: str | Path):
        meta = json.loads((Path(path) / f"{self.view_id}.json").read_text())
        self.room_id = meta["room_id"]
        self.img_id = meta["img_id"]
        self.img_path = meta["img_path"]
        self.object_ids = meta["object_ids"]
        self.text_discription = meta["text_discription"]
        return self
