"""Graph visualization CLI (counterpart of
holoagent_tpu/apps/visualize_graph.py): a top-down scene map with room
footprints, object markers and labels and the navigation graph, a
floors/rooms/objects hierarchy diagram, and a keyframe overlay of the scene
points.

matplotlib (the ``Agg`` backend) is imported inside the functions that draw:
importing this module, or ``render_pcd_on_image`` (numpy over
``utils/camera.project``), needs no matplotlib; a drawing function on a
machine without it raises ``ImportError`` naming the package.

Usage:
  python -m holoagent_tpu_torch.apps.visualize_graph --graph <dir> [--nav nav.json] [--out DIR]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..memory.hmsg import HMSGraph
from ..utils.camera import Pinhole, project


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("visualize_graph draws with matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def render_pcd_on_image(
    points: np.ndarray,  # (N, 3) world points
    colors: np.ndarray,  # (N, 3) in [0, 1]
    pose: np.ndarray,  # (4, 4) camera-to-world
    k: np.ndarray,  # (3, 3) intrinsics
    hw: tuple,
    background: np.ndarray | None = None,  # (H, W, 3) frame to draw over
) -> np.ndarray:
    """Project scene points into a keyframe view (the debug overlay of
    reference utils/graph_utils.py:25-92): an (H, W, 3) float image,
    painter's order by depth (near points drawn last), over `background`."""
    h, w = hw
    img = (
        np.asarray(background, np.float32).copy()
        if background is not None
        else np.zeros((h, w, 3), np.float32)
    )
    t_wc = np.linalg.inv(np.asarray(pose, np.float64))
    pc = (t_wc[:3, :3] @ np.asarray(points, np.float64).T).T + t_wc[:3, 3]
    z = pc[:, 2]
    uv, depth = project(torch.from_numpy(pc.astype(np.float32)), Pinhole.from_matrix(k))
    uv = uv.numpy()
    ok = depth.numpy() > 1e-3
    u = np.round(uv[:, 0]).astype(int)
    v = np.round(uv[:, 1]).astype(int)
    ok &= (u >= 0) & (u < w) & (v >= 0) & (v < h)
    order = np.argsort(-z[ok])  # far first; near points overwrite
    uu, vv = u[ok][order], v[ok][order]
    img[vv, uu] = np.asarray(colors, np.float32)[ok][order]
    return np.clip(img, 0.0, 1.0)


def render_top_down(graph: HMSGraph, out_path: str | Path, nav_graph=None) -> None:
    """Rooms' points coloured per room with their ids and names, objects as
    markers with their names, and the navigation graph's edges (a
    ``memory.navgraph.Graph``), from above, as a PNG."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(10, 8))
    cmap = plt.get_cmap("tab20")
    for floor in graph.floors:
        for ri, room in enumerate(floor.rooms):
            v = np.asarray(room.vertices)
            step = max(len(v) // 4000, 1)
            ax.scatter(v[::step, 0], v[::step, 1], s=1.0, color=cmap(ri % 20), alpha=0.4)
            c = v.mean(axis=0)
            ax.text(c[0], c[1], f"{room.room_id}\n{room.name}", fontsize=8,
                    ha="center", weight="bold")
    for obj in graph.objects:
        c = obj.center()
        ax.plot(c[0], c[1], "k^", ms=5)
        ax.text(c[0], c[1] + 0.08, obj.name or "?", fontsize=6, ha="center")
    if nav_graph is not None and nav_graph.number_of_nodes():
        for a, b in nav_graph.edges():
            pa, pb = nav_graph.nodes[a]["pos"], nav_graph.nodes[b]["pos"]
            ax.plot([pa[0], pb[0]], [pa[1], pb[1]], "r-", lw=0.5, alpha=0.6)
    ax.set_aspect("equal")
    ax.set_title("HMSG top-down map")
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def render_hierarchy(graph: HMSGraph, out_path: str | Path) -> None:
    """The floors -> rooms -> objects tree as a PNG."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(12, 6))
    y_floor, y_room, y_obj = 2.0, 1.0, 0.0
    x = 0.0
    for floor in graph.floors:
        room_xs = []
        for room in floor.rooms:
            obj_xs = []
            for obj in room.objects:
                ax.text(x, y_obj, obj.name or obj.object_id, fontsize=6,
                        rotation=45, ha="right")
                obj_xs.append(x)
                x += 0.6
            rx = float(np.mean(obj_xs)) if obj_xs else x
            if not obj_xs:
                x += 0.6
            ax.text(rx, y_room, f"{room.room_id}:{room.name}", fontsize=8, ha="center")
            for ox in obj_xs:
                ax.plot([rx, ox], [y_room - 0.05, y_obj + 0.15], "k-", lw=0.4)
            room_xs.append(rx)
        fx = float(np.mean(room_xs)) if room_xs else x
        ax.text(fx, y_floor, f"floor {floor.floor_id}", fontsize=10, ha="center",
                weight="bold")
        for rx in room_xs:
            ax.plot([fx, rx], [y_floor - 0.05, y_room + 0.1], "k-", lw=0.6)
    ax.axis("off")
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", required=True)
    ap.add_argument("--nav", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    g = HMSGraph.load(args.graph)
    nav = None
    if args.nav:
        from ..memory.navgraph import load_graph

        nav = load_graph(args.nav)
    out = Path(args.out or args.graph)
    render_top_down(g, out / "map_top_down.png", nav)
    render_hierarchy(g, out / "hierarchy.png")
    print(f"wrote {out / 'map_top_down.png'} and {out / 'hierarchy.png'}")


if __name__ == "__main__":
    main()
