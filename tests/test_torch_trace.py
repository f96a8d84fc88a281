"""The port's recorder of spans and counters (``tpualign_torch.trace``) on
the CPU paths: off it records nothing and hands out one shared null
context; on, each entry call is one recorded call whose spans nest under
its root with the right parents; counters move by the work done, the leaf
walkers' sums included; recordings nest, ``take`` clears, a label factory
sees every span once and in order; each ``stats=`` key that times a span's
work is that span's duration; ``python -m tpualign_torch score|align
--trace FILE`` writes the records.  Small random pairs from a seed."""

import contextlib
import json
import threading

import numpy as np
import pytest

from tpualign_torch import (AlignMode, EngineConfig, ScoringConfig, align, align_score,
                            align_score_batch, api, cli, trace)
from tpualign_torch.io import bdna
from tpualign_torch.ops import affine_align, band_align, hirschberg, traceback, traceback_diag

CPU = EngineConfig(device="cpu")
SW = ScoringConfig(match=2, mismatch=-1, gap=-2, mode=AlignMode.LOCAL)
NW = ScoringConfig()
AFFINE = ScoringConfig(match=2, mismatch=-1, gap_open=-5, gap_extend=-2)
AFFINE_SW = ScoringConfig(match=2, mismatch=-1, gap_open=-5, gap_extend=-2,
                          mode=AlignMode.LOCAL)


def _pair(m, n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(1, 5, m).astype(np.int8), rng.integers(1, 5, n).astype(np.int8)


@pytest.fixture(autouse=True)
def fresh():
    """No records left from another test, none left for the next."""
    trace.take()
    yield
    trace.take()


@pytest.fixture
def small_tree(monkeypatch):
    """``align`` past the full table, with k-way and binary nodes, on
    test-sized pairs."""
    monkeypatch.setattr(api, "FULL_TABLE_CELL_LIMIT", 3000)
    monkeypatch.setattr(hirschberg, "BASE_CELLS", 3000)
    monkeypatch.setattr(hirschberg, "KWAY_MIN_ROWS", 300)
    monkeypatch.setattr(hirschberg, "KWAY_LEAF_ROWS", 70)
    monkeypatch.setattr(band_align, "SW_WINDOW_LIMIT", 0)
    monkeypatch.setattr(affine_align, "BASE_CELLS", 300)


def _names(call):
    return [s.name for s in call.spans]


def _well_formed(call):
    """Every span lies inside its parent, the parents open first, and the
    root is span 0."""
    assert call.spans[0].parent is None and call.spans[0].name == call.name
    for k, s in enumerate(call.spans[1:], 1):
        assert s.call == call.id and s.parent is not None and s.parent < k
        p = call.spans[s.parent]
        assert p.t0 <= s.t0 <= s.t1 <= p.t1


def test_off_records_nothing_and_shares_one_null_context(small_tree):
    assert not trace._on
    assert trace.span("plan") is trace.span("read_back")
    with trace.span("plan") as got:
        assert got is None
    s1, s2 = _pair(400, 420, 1)
    align_score(s1, s2, SW, CPU)
    align(s1, s2, SW, CPU)
    assert trace.take() == []


def test_a_timed_span_off_gives_its_seconds_and_records_nothing():
    with trace.span("walk", timed=True) as clock:
        sum(range(1000))
    assert clock.seconds > 0 and trace.take() == []


@pytest.mark.parametrize("entry, impl", [
    ("align_score", "band"), ("align_score", "bitpal"), ("align", "band"),
    ("align", "bitpal"), ("align", "affine"), ("align_score_batch", "band"),
    ("align_score_batch", "bitpal"),
])
def test_one_call_per_entry_call_with_nested_spans(small_tree, entry, impl):
    cfg = {"band": SW, "bitpal": NW, "affine": AFFINE}[impl]
    s1, s2 = _pair(400, 420, 2)
    run = {"align_score": lambda: align_score(s1, s2, cfg, CPU),
           "align": lambda: align(s1, s2, cfg, CPU),
           "align_score_batch": lambda: align_score_batch([s1, s2], [s2, s1], cfg, CPU)}[entry]
    with trace.recording():
        run()
        run()
    calls = trace.take()
    assert [c.name for c in calls] == [entry, entry]
    assert calls[1].id == calls[0].id + 1 and not any(c.raised for c in calls)
    for call in calls:
        _well_formed(call)
        assert call.root.attrs == {"impl": impl}
        assert "read_back" in _names(call)
    assert _names(calls[0]) == _names(calls[1])
    if entry == "align":
        names = _names(calls[0])
        assert {"tree", "bisect", "leaves.wait", "assemble", "to_device"} <= set(names)
        tree = names.index("tree")
        for name in ("bisect", "leaves.wait", "assemble"):
            assert calls[0].spans[names.index(name)].parent == tree
        if impl == "band":  # the local route: the two locates, then the core
            assert names[1:6] == ["route", "align_local", "locate", "check", "to_device"]
            assert "start" in names and "node.kway" in names
    if entry == "align_score_batch":
        assert "pack" in _names(calls[0]) and calls[0].counters["pairs"] == 2


def test_the_spans_of_a_binary_node_and_its_crossing(small_tree):
    s1, s2 = _pair(260, 250, 3)  # under KWAY_MIN_ROWS rows: binary nodes only
    with trace.recording():
        align(s1, s2, NW, CPU)
    (call,) = trace.take()
    names = _names(call)
    nodes = [k for k, n in enumerate(names) if n == "node.binary"]
    bisect = names.index("bisect")
    assert nodes and call.spans[nodes[0]].parent == bisect  # the root node
    # each later node is submitted as a child of a node before it
    assert all(names[call.spans[k].parent] == "submit" for k in nodes[1:])
    assert all(call.spans[k].parent == bisect for k, n in enumerate(names) if n == "submit")
    assert call.counters["nodes.binary"] == len(nodes)
    assert names.count("read_back") == len(nodes)  # each node's crossing row
    assert names.count("submit") == len(nodes)  # each node's two children
    assert all(call.spans[k].parent == bisect for k, n in enumerate(names) if n == "read_back")


def test_an_entry_inside_another_is_a_span_of_its_call(small_tree, monkeypatch):
    # where both batch kernels refuse a batch, it loops over align_score
    from tpualign_torch.ops import band_batch, bitpal

    def refuse(*args, **kwargs):
        raise ValueError("refused")

    monkeypatch.setattr(bitpal, "score_batch", refuse)
    monkeypatch.setattr(band_batch, "score_batch", refuse)
    s1, s2 = _pair(60, 50, 4)
    with trace.recording():
        got = align_score_batch([s1, s2], [s2, s1], NW, CPU)
    (call,) = trace.take()
    assert call.name == "align_score_batch"
    inner = [k for k, s in enumerate(call.spans) if s.name == "align_score"]
    assert len(inner) == 2 and all(call.spans[k].parent == 0 for k in inner)
    assert got.tolist() == [align_score(s1, s2, NW, CPU), align_score(s2, s1, NW, CPU)]


def test_a_call_that_raises_is_recorded_as_raised():
    with trace.recording():
        with pytest.raises(ValueError):
            align_score_batch([np.ones(3, np.int8)], [], NW, CPU)
    (call,) = trace.take()
    assert call.name == "align_score_batch" and call.raised


def test_counters_move_by_the_work_and_the_calls_keep_their_share(small_tree):
    s1, s2 = _pair(400, 420, 5)
    before = trace.counters()
    stats = {}
    with trace.recording():
        align(s1, s2, SW, CPU, stats=stats)
    (call,) = trace.take()
    after = trace.counters()
    moved = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
    assert call.counters == moved
    core = stats["core_stats"]
    assert moved["leaves"] == core["leaves"] > 1
    assert moved["leaf_cells"] == core["leaf_cells"]
    assert moved["nodes.kway"] == core["kway_nodes"] >= 1
    assert moved.get("nodes.binary", 0) == core["binary_nodes"]
    # the walkers' sums come back through their futures
    assert moved["leaf_walk_ns"] == pytest.approx(core["leaf_walk_s"] * 1e9, abs=1)
    assert moved["leaf_queue_ns"] >= 0
    assert not any(k.startswith("launch.") for k in moved)  # no kernel on the CPU


def test_counters_count_without_recording():
    before = trace.counters()
    trace.count("test.things", 3)
    trace.count("test.things")
    assert trace.counters()["test.things"] == before.get("test.things", 0) + 4
    assert trace.take() == []


def test_recordings_nest_and_take_clears():
    with trace.recording():
        with trace.recording():
            with trace.span("inner"):
                pass
        assert trace._on
        with trace.span("outer"):
            pass
    assert not trace._on
    assert [c.name for c in trace.take()] == ["inner", "outer"]
    assert trace.take() == []


def test_the_label_gets_every_span_once_in_order(small_tree):
    seen = []

    @contextlib.contextmanager
    def label(name):
        seen.append(("enter", name))
        yield
        seen.append(("exit", name))

    s1, s2 = _pair(400, 420, 6)
    with trace.recording(label=label):
        align(s1, s2, SW, CPU)
    (call,) = trace.take()
    assert [n for kind, n in seen if kind == "enter"] == _names(call)
    assert sorted(n for kind, n in seen if kind == "exit") == sorted(_names(call))
    assert seen[0] == ("enter", "align") and seen[-1] == ("exit", "align")
    # the innermost recording with a label decides; the default comes back
    with trace.recording(label=label):
        with trace.recording():
            seen.clear()
            with trace.span("x"):
                pass
    assert seen == [("enter", "x"), ("exit", "x")]
    assert trace._label is trace._default_label


def test_spans_on_another_thread_are_not_recorded():
    seen = []
    with trace.recording():
        with trace.span("main"):
            worker = threading.Thread(target=lambda: seen.append(trace.span("other")))
            worker.start()
            worker.join(timeout=30)
    assert not worker.is_alive() and seen == [trace.span("other")]
    assert [_names(c) for c in trace.take()] == [["main"]]


def test_tag_sets_attributes_on_the_innermost_open_span():
    with trace.recording():
        with trace.span("root"):
            trace.tag(impl="band")
            with trace.span("child"):
                trace.tag(rows=3)
            trace.tag(more=1)
    (call,) = trace.take()
    assert call.spans[0].attrs == {"impl": "band", "more": 1}
    assert call.spans[1].attrs == {"rows": 3}
    trace.tag(ignored=True)  # nothing is recorded: no error


def _span(call, name):
    (s,) = [s for s in call.spans if s.name == name]
    return s


@pytest.mark.parametrize("path", ["sw", "nw", "affine", "affine_sw", "diag", "checkpointed"])
def test_each_stats_key_is_its_spans_duration(small_tree, path):
    s1, s2 = _pair(400, 420, 7)
    stats = {}
    # a root of the test's own: an op's spans outside an entry point are
    # roots each
    with trace.recording(), trace.span("case"):
        if path == "sw":
            band_align.align_local(s1, s2, SW, device="cpu", stats=stats)
        elif path == "nw":
            hirschberg.align(s1, s2, NW, device="cpu", stats=stats)
        elif path == "affine":
            affine_align.align(s1, s2, AFFINE, device="cpu", stats=stats)
        elif path == "affine_sw":
            affine_align.align_local(s1, s2, AFFINE_SW, device="cpu", stats=stats)
        elif path == "diag":
            traceback_diag.align_diag(s1, s2, SW, device="cpu", stats=stats)
        else:
            traceback.align_checkpointed(s1, s2, NW, device="cpu", stats=stats)
    (call,) = trace.take()
    _well_formed(call)
    keys = {"sw": [("locate_s", "locate"), ("start_s", "start"), ("wall_s", "align_local")],
            "affine_sw": [("locate_s", "locate"), ("start_s", "start"),
                          ("wall_s", "align_local")],
            "nw": [("bisect_s", "bisect"), ("wall_s", "tree")],
            "affine": [("bisect_s", "bisect"), ("wall_s", "tree")],
            "diag": [("copy_s", "copy"), ("walk_s", "walk")],
            "checkpointed": [("forward_s", "fill"), ("copy_s", "copy"), ("walk_s", "walk")]}
    for key, name in keys[path]:
        assert stats[key] == _span(call, name).seconds, key
    if path in ("sw", "affine_sw"):
        core = stats["core_stats"]
        assert core["bisect_s"] == _span(call, "bisect").seconds
        assert core["wall_s"] == _span(call, "tree").seconds
    if path == "diag":  # the host clock's fill on the CPU
        assert stats["fill_ms"] == _span(call, "fill").seconds * 1e3
        assert call.counters["bands"] == stats["bands"]
    if path == "checkpointed":
        assert call.counters["blocks"] == stats["blocks"]


def test_stats_keep_their_keys_without_recording(small_tree):
    s1, s2 = _pair(400, 420, 8)
    stats = {}
    band_align.align_local(s1, s2, SW, device="cpu", stats=stats)
    assert {"end", "vmax", "locate_s", "route", "start", "core", "core_stats", "start_s",
            "wall_s"} <= set(stats)
    assert {"kway_nodes", "binary_nodes", "leaves", "leaf_cells", "bisect_s", "leaf_walk",
            "leaf_walk_s", "wall_s"} <= set(stats["core_stats"])
    assert stats["wall_s"] >= stats["locate_s"] + stats["start_s"] > 0
    assert trace.take() == []


@pytest.mark.parametrize("cmd", ["score", "align"])
def test_cli_trace_writes_the_records(tmp_path, capsys, cmd):
    a, b = tmp_path / "a.bdna", tmp_path / "b.bdna"
    s1, s2 = _pair(300, 280, 9)
    bdna.write_bdna(str(a), s1)
    bdna.write_bdna(str(b), s2)
    out = tmp_path / "trace.json"
    args = [cmd, str(a), str(b), "--device", "cpu", "--trace", str(out)]
    if cmd == "align":
        args += ["--out", str(tmp_path / "aln.txt")]
    assert cli.main(args) == 0
    printed = capsys.readouterr().out.splitlines()
    assert printed[1] == f"Score: {align_score(s1, s2, NW, CPU)}"
    got = json.loads(out.read_text())
    (call,) = got["calls"]
    assert call["name"] == {"score": "align_score", "align": "align"}[cmd]
    assert call["spans"][0]["parent"] is None and call["spans"][0]["attrs"]["impl"]
    assert all(s["t0_ns"] <= s["t1_ns"] for s in call["spans"])
    assert isinstance(got["counters"], dict)
    assert trace.take() == []  # the command took its records
