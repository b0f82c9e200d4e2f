"""visualize_graph and tracing in the port against the JAX package:
render_pcd_on_image bit for bit; the top-down map and the hierarchy PNGs of
one saved graph equal pixel for pixel; device_trace writes a Chrome trace
holding annotate's ranges."""

import json

import jax
import networkx as nx
import numpy as np
import pytest
import torch
from matplotlib.image import imread

from holoagent_tpu.apps import visualize_graph as jvis
from holoagent_tpu.memory import hmsg as jhmsg
from holoagent_tpu.memory import nodes as jnodes
from holoagent_tpu_torch.apps import visualize_graph as tvis
from holoagent_tpu_torch.memory import hmsg as thmsg
from holoagent_tpu_torch.memory import navgraph
from holoagent_tpu_torch.utils import tracing

from test_torch_slow_query import _view_graph


def _pose(rng):
    """A camera-to-world pose looking at the points from about 4 m away."""
    a = rng.uniform(0, 2 * np.pi)
    r = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    pose = np.eye(4)
    pose[:3, :3] = r
    pose[:3, 3] = -r @ np.array([0.0, 0.0, 4.0])
    return pose


@pytest.mark.parametrize("background", [False, True])
def test_render_pcd_on_image_bit_for_bit(background):
    rng = np.random.default_rng(3)
    pts = rng.uniform(-1.5, 1.5, (4000, 3))
    cols = rng.uniform(0, 1, (4000, 3))
    k = np.array([[120.0, 0, 79.5], [0, 120.0, 59.5], [0, 0, 1]])
    bg = rng.uniform(0, 1, (120, 160, 3)).astype(np.float32) if background else None
    pose = _pose(rng)
    want = jvis.render_pcd_on_image(pts, cols, pose, k, (120, 160), background=bg)
    got = tvis.render_pcd_on_image(pts, cols, pose, k, (120, 160), background=bg)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)
    assert (got != (bg if background else 0)).any()


def test_graph_pngs_equal(tmp_path):
    """One graph saved by the JAX package, loaded by each; a 4-node
    navigation graph in each package's graph type."""
    _view_graph(jnodes, jhmsg.HMSGraph).save(tmp_path / "graph")
    jg, tg = jhmsg.HMSGraph.load(tmp_path / "graph"), thmsg.HMSGraph.load(tmp_path / "graph")
    pos = {0: (0.5, 0.5), 1: (2.5, 0.5), 2: (2.5, 2.5), 3: (0.5, 2.5)}
    jnav, tnav = nx.Graph(), navgraph.Graph()
    for n, p in pos.items():
        jnav.add_node(n, pos=p)
        tnav.add_node(n, pos=p)
    for a, b in ((0, 1), (1, 2), (2, 3)):
        jnav.add_edge(a, b)
        tnav.add_edge(a, b)
    for name, jdraw, tdraw in (("top_down", lambda p: jvis.render_top_down(jg, p, jnav),
                                lambda p: tvis.render_top_down(tg, p, tnav)),
                               ("hierarchy", lambda p: jvis.render_hierarchy(jg, p),
                                lambda p: tvis.render_hierarchy(tg, p))):
        jdraw(tmp_path / f"j_{name}.png")
        tdraw(tmp_path / f"t_{name}.png")
        a, b = imread(tmp_path / f"j_{name}.png"), imread(tmp_path / f"t_{name}.png")
        assert a.shape == b.shape and a.shape[0] > 100, name
        assert np.array_equal(a, b), name


def test_module_imports_without_matplotlib(monkeypatch):
    """Drawing raises a plain ImportError naming matplotlib where it is
    absent; the overlay needs none."""
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        tvis.render_hierarchy(thmsg.HMSGraph(), "unused.png")
    img = tvis.render_pcd_on_image(np.zeros((1, 3)) + [0, 0, 2], np.ones((1, 3)), np.eye(4),
                                   np.array([[10.0, 0, 4], [0, 10, 4], [0, 0, 1]]), (8, 8))
    assert img[4, 4].tolist() == [1.0, 1.0, 1.0]


def test_device_trace_holds_annotated_ranges(tmp_path):
    x = torch.randn(64, 64)
    with tracing.device_trace(tmp_path / "trace") as prof:
        with tracing.annotate("fixture_step"):
            y = x @ x
        with tracing.annotate("second_range"):
            y = torch.relu(y)
    events = json.loads((tmp_path / "trace" / tracing.TRACE_FILE).read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"fixture_step", "second_range"} <= names
    assert any(e.key == "fixture_step" for e in prof.key_averages())
    share = tracing.device_idle_share(prof, 1.0)
    assert share["kernels"] == 0 and share["idle_share"] == 1.0  # no card here
    with tracing.device_trace(tmp_path / "off", enabled=False) as off:
        assert off is None
    assert not (tmp_path / "off").exists()
    assert tracing.StageTimer is __import__("holoagent_tpu_torch.utils.timing", fromlist=["StageTimer"]).StageTimer
    assert jax.__name__ == "jax"  # both packages import side by side
