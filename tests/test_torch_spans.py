"""The port's stage spans (``utils/timing.StageTimer``) on the CPU.

On the CPU a span takes the host clock, and so it does on the card while
the stream captures a CUDA graph; there the tests stand in for the card by
monkeypatching the capture query and the sync-debug mode, and raise torch's
sync warning themselves.  Also: the ``dispatch`` span of ``Mapper.run``,
the benchmark's ``host_syncs.map`` reader, and ``tracing.device_idle_share``
on synthetic device intervals.
"""

import importlib.util
import time
import warnings
from contextlib import nullcontext
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from holoagent_tpu_torch.config import from_dict
from holoagent_tpu_torch.dataloader import SyntheticDataset
from holoagent_tpu_torch.memory.mapping import Mapper
from holoagent_tpu_torch.models import clip as tclip
from holoagent_tpu_torch.models import sam as tsam
from holoagent_tpu_torch.utils import timing, tracing
from holoagent_tpu_torch.utils.timing import SYNC, SYNC_WARNING, StageTimer, stage

REPO = Path(__file__).resolve().parents[1]
SYNC_MESSAGE = SYNC_WARNING + " (Triggered internally at c10/cuda/CUDAFunctions.cpp:1.)"


def test_nested_spans_record_parents_calls_and_nest_in_time():
    t = StageTimer("cpu")
    with t.stage("outer"):
        for _ in range(2):
            with t.stage("outer.a"):
                time.sleep(0.002)
        with t.stage("outer.b"):
            with t.stage("outer.b.inner"):
                time.sleep(0.001)
    with t.stage("outer"):
        pass
    assert t.parent == {"outer": None, "outer.a": "outer", "outer.b": "outer", "outer.b.inner": "outer.b"}
    assert {k: t.calls[k] for k in t.parent} == {"outer": 2, "outer.a": 2, "outer.b": 1, "outer.b.inner": 1}
    ms = t.ms
    assert ms["outer.a"] >= 4.0
    assert ms["outer.a"] + ms["outer.b"] <= ms["outer"]
    assert ms["outer.b.inner"] <= ms["outer.b"]
    assert not t._open and not t._pending


def test_sync_keys_are_written_for_every_span_and_read_zero_on_the_cpu():
    t = StageTimer("cpu")
    with t.stage("a"):
        with t.stage("b"):
            torch.arange(8).nonzero()
            int(torch.tensor(3))
    assert {k: v for k, v in t.calls.items() if k.endswith(SYNC)} == {"a" + SYNC: 0, "b" + SYNC: 0}


def test_a_span_closes_on_an_exception():
    t = StageTimer("cpu")
    with pytest.raises(ValueError):
        with t.stage("a"):
            raise ValueError("inside")
    assert t.calls["a"] == 1 and not t._open


def test_no_timer_installs_nothing(monkeypatch):
    monkeypatch.setattr(timing, "_SyncCounter", None)  # any use would raise
    show, filters = warnings.showwarning, list(warnings.filters)
    ctx = stage(None, "mask")
    assert isinstance(ctx, nullcontext)
    with ctx:
        assert warnings.showwarning is show and warnings.filters == filters


@pytest.fixture
def card_stand_in(monkeypatch):
    """A "cuda" timer's host side: the capture query says the stream is
    capturing (so spans take the host clock), and the sync-debug mode is a
    plain variable."""
    mode = {"now": 0, "set": []}

    def set_mode(m):
        m = {"default": 0, "warn": 1, "error": 2}.get(m, m)
        mode["now"] = m
        mode["set"].append(m)
        warnings.warn(timing.PROTOTYPE_NOTICE + " and does not yet detect all synchronizing operations")

    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: mode["now"])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)
    return mode


def test_blocking_waits_count_in_the_innermost_span_and_the_state_is_restored(card_stand_in):
    mode = card_stand_in
    t = StageTimer("cuda")
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("default")
        show, filters = warnings.showwarning, list(warnings.filters)
        with t.stage("outer"):
            assert mode["now"] == 1
            warnings.warn(SYNC_MESSAGE, UserWarning)
            with t.stage("outer.inner"):
                for _ in range(3):  # one call site: counted each time, not once
                    warnings.warn(SYNC_MESSAGE, UserWarning)
                warnings.warn("another warning", UserWarning)
            assert mode["now"] == 1  # the outermost span holds it
        assert mode["now"] == 0 and mode["set"] == [1, 0]
        assert warnings.showwarning is show and warnings.filters == filters
        warnings.warn(SYNC_MESSAGE, UserWarning)  # outside every span: not counted
    assert t.calls["outer" + SYNC] == 1 and t.calls["outer.inner" + SYNC] == 3
    assert [str(w.message) for w in seen] == ["another warning", SYNC_MESSAGE]  # no sync warning printed inside
    assert t.ms["outer"] >= t.ms["outer.inner"] and t.calls["outer"] == 1


def test_a_mode_already_set_is_left_as_it_was(card_stand_in):
    mode = card_stand_in
    mode["now"] = 2
    t = StageTimer("cuda")
    with t.stage("a"):
        assert mode["now"] == 2
    assert mode["now"] == 2 and mode["set"] == [2]


def test_spans_name_themselves_in_the_profiler_without_a_user_annotation():
    t = StageTimer("cpu")
    x = torch.randn(32, 32)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with t.stage("span.a"):
            x @ x
        with tracing.annotate("region.b"):
            x + x
    ev = {e.name: e for e in prof.events()}
    for name in ("span.a", "region.b"):
        assert not ev[name].is_user_annotation
        assert ev[name].device_type == torch.autograd.DeviceType.CPU
    assert ev["span.a"].time_range.start <= ev["aten::mm"].time_range.start < ev["span.a"].time_range.end


CFG = {
    "main": {"depth_cut": 20.0},
    "models": {
        "clip": {"type": "test-tiny", "dtype": "float32"},
        "sam": {"type": "test-tiny", "points_per_side": 4, "pred_iou_thresh": -10.0, "stability_score_thresh": 0.0,
                "min_mask_region_area": 20, "max_masks": 8},
    },
    "pipeline": {"voxel_size": 0.1, "skip_frames": 1, "point_capacity": 1 << 14, "mask_point_capacity": 256,
                 "instance_capacity": 32, "instance_max_area_frac": 1.0, "merge_type": "paired",
                 "extract_tiering": True, "paired_full_round_every": 2},
}


@pytest.mark.parametrize("bsz, groups", [(1, 3), (2, 2)])
def test_mapper_run_opens_one_dispatch_span_a_group(bsz, groups):
    torch.manual_seed(0)
    clip = tclip.init_clip_visual(tclip.VARIANTS["test-tiny"], seed=0, device="cpu", impl="xla")
    sam = tsam.init_sam(tsam.VARIANTS["test-tiny"], seed=1, device="cpu")
    cfg = from_dict({**CFG, "pipeline": {**CFG["pipeline"], "extract_frames_per_dispatch": bsz}})
    ds = SyntheticDataset(num_frames=4, hw=(48, 64))
    t = StageTimer("cpu")
    Mapper(cfg, clip, sam, device="cpu", timer=t).run([ds[i] for i in range(3)])
    assert t.calls["dispatch"] == groups and t.parent["dispatch"] is None
    assert t.calls["backproject"] == 3 and t.parent["backproject"] == "dispatch"
    assert t.parent["mask"] == "dispatch" and t.parent["finalize"] is None
    assert t.calls["mask"] == (3 if bsz == 1 else 2)  # a pair and a last single frame
    top = [k for k, p in t.parent.items() if p == "dispatch"]
    assert sum(t.ms[k] for k in top) <= t.ms["dispatch"]


def _reader(name):
    spec = importlib.util.spec_from_file_location(f"metric_{name}", REPO / "portbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_host_syncs_reader_sums_the_sync_counts_a_keyframe():
    read = _reader("host_syncs.map")
    calls = {"dispatch": 96, "dispatch#sync": 0, "backproject": 96, "backproject#sync": 288, "mask": 96,
             "mask#sync": 480, "finalize": 2, "finalize#sync": 16}
    assert read({"keyframes": 96, "stage_calls": calls}) == pytest.approx((288 + 480 + 16) / 96)
    assert read({"keyframes": 96, "stage_calls": {k: v for k, v in calls.items() if SYNC not in k}}) is None
    assert read({"keyframes": 0, "stage_calls": calls}) is None
    assert read({}) is None


@pytest.mark.parametrize("intervals, want", [
    ([], 0.0),
    ([(0.0, 1.0)], 1.0),
    ([(0.0, 1.0), (2.0, 3.0)], 2.0),
    ([(0.0, 2.0), (1.0, 3.0)], 3.0),  # overlapping: counted once
    ([(1.0, 2.0), (0.0, 5.0), (4.0, 6.0)], 6.0),  # nested and out of order
    ([(0.0, 1.0), (1.0, 2.0)], 2.0),  # touching
])
def test_busy_is_the_union_of_intervals(intervals, want):
    assert tracing.busy(intervals) == pytest.approx(want)


def test_device_idle_share_takes_the_union_and_skips_user_annotations():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(start_us, end_us, device=cuda, annotation=False):
        return SimpleNamespace(device_type=device, is_user_annotation=annotation,
                               time_range=SimpleNamespace(start=start_us, end=end_us))

    prof = SimpleNamespace(events=lambda: [
        ev(0, 2000), ev(1000, 3000),  # two kernels on two streams, overlapping for 1 ms
        ev(5000, 6000),
        ev(0, 10000, annotation=True),  # the profiler's device copy of a record_function range
        ev(0, 10000, device=cpu),
    ])
    share = tracing.device_idle_share(prof, 10.0)
    assert share["kernels"] == 3
    assert share["device_ms"] == pytest.approx(4.0)
    assert share["idle_share"] == pytest.approx(0.6)
