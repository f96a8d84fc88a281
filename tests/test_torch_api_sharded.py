"""The sharded engines through the port's API and both of its transports.

- ``resolve_impl`` equal to ``tpualign.api.resolve_impl`` (as on a TPU)
  over a grid of configs and shapes, with both packages' device counts
  patched to 8 and to 1: the port's default group of 8 or 1 shards,
  ``jax.devices()`` cut to as many.
- ``align_score`` under each sharded name: ``tpualign``'s scores and its
  fallbacks (``bitpal-strips`` outside the family to ``strips``,
  ``band-strips`` under affine gaps to ``strips`` or, with a matrix, to
  ``band``), its refusals (``strips`` and a matrix); ``chunk_rows``
  validated as ``tpualign``'s; a ValueError from inside a pipeline is
  raised, not rerouted; ``align`` under a sharded name past the full
  table takes ``align_checkpointed``, as ``tpualign`` does.
- ``hirschberg.align_sharded``: the strings of
  ``tpualign.ops.hirschberg.align_sharded`` (8 virtual devices, interpret
  mode) on P = 4 shards.
- One ``torch.distributed`` world of 4 gloo ranks (a file store), spawned
  once for all its cases (``tests/torch_dist_ranks.py``, which imports
  neither ``jax`` nor ``tpualign``): every rank's result of every case is
  the in-process group's of 4 shards, and the scores ``tpualign``'s.
"""

import itertools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import tpualign
import tpualign.api as japi
from tpualign import matrices as jmatrices
from tpualign.config import AlignMode as JMode
from tpualign.config import EngineConfig as JEngine
from tpualign.config import ScoringConfig as JScoring
from tpualign.ops import hirschberg as jhirschberg
from tpualign.ops import oracle as joracle
from tpualign.parallel.mesh import make_mesh
from tpualign_torch import api, matrices
from tpualign_torch.config import AlignMode, EngineConfig, ScoringConfig
from tpualign_torch.ops import hirschberg
from tpualign_torch.parallel import mesh

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)

import torch_dist_ranks  # noqa: E402


def _pair(m, n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(1, 5, m).astype(np.int8), rng.integers(1, 5, n).astype(np.int8)


def _cfgs(kw):
    kw = dict(kw)
    mode = kw.pop("mode", "GLOBAL")
    if kw.pop("matrix", False):
        return (ScoringConfig(mode=AlignMode[mode], matrix=matrices.dna(), **kw),
                JScoring(mode=JMode[mode], matrix=jmatrices.dna(), **kw))
    return ScoringConfig(mode=AlignMode[mode], **kw), JScoring(mode=JMode[mode], **kw)


CONFIGS = [dict(), dict(gap=-2), dict(match=3, mismatch=2, gap=-1), dict(gap=-8),
           dict(match=2, mismatch=-1, gap=-2, mode="LOCAL"),
           dict(match=2, mismatch=-1, gap_open=-5, gap_extend=-2),
           dict(match=2, mismatch=-1, gap_open=-5, gap_extend=-2, mode="LOCAL"),
           dict(gap_open=-5, gap_extend=-2, mode="SEMIGLOBAL"),
           dict(gap=-2, mode="SEMIGLOBAL"), dict(gap=-2, mode="INFIX"),
           dict(matrix=True, gap=-2), dict(matrix=True, gap_open=-5, gap_extend=-1)]
SHAPES = [(4096 * 8, 4096 * 8), (5000, 5000), (4096 * 8, 100), (100, 4096 * 8),
          (4096 * 8 - 1, 4096 * 8 - 1), (40000, 32767), (4096, 4096)]


@pytest.mark.parametrize("n_dev", [8, 1])
def test_resolve_impl_matches_jax(monkeypatch, n_dev):
    """``auto`` over the grid, both packages seeing ``n_dev`` devices; an
    explicit name always wins."""
    devices = jax.devices()[:n_dev]
    monkeypatch.setattr(japi, "_platform", lambda: "tpu")
    monkeypatch.setattr(jax, "devices", lambda *a: devices)
    monkeypatch.setattr(mesh, "default_group", lambda device="cuda": mesh.Group(["cpu"] * n_dev))
    seen = set()
    for kw, shape in itertools.product(CONFIGS, SHAPES):
        cfg, jcfg = _cfgs(kw)
        got = api.resolve_impl(EngineConfig(device="cpu"), cfg, shape)
        assert got == japi.resolve_impl(JEngine(), jcfg, shape), (kw, shape)
        seen.add(got)
    assert seen == ({"bitpal", "band", "bitpal-strips", "band-strips", "strips"}
                    if n_dev == 8 else {"bitpal", "band"})
    for impl in ("xla", "strips", "bitpal-strips"):
        assert api.resolve_impl(EngineConfig(impl=impl), ScoringConfig(), SHAPES[0]) == impl


@pytest.mark.parametrize("impl", ["bitpal-strips", "band-strips", "strips"])
@pytest.mark.parametrize("kw", [dict(), dict(match=2, mismatch=-1, gap=-2, mode="LOCAL"),
                                dict(match=2, mismatch=1, gap=-2)],
                         ids=["unit", "sw", "outside the family"])
def test_align_score_sharded_names(monkeypatch, impl, kw):
    """Each sharded name on a default group of 3 shards: ``tpualign``'s
    score (``bitpal-strips`` outside the family falls back to
    ``strips``)."""
    monkeypatch.setattr(mesh, "default_group", lambda device="cuda": mesh.Group(["cpu"] * 3))
    cfg, jcfg = _cfgs(kw)
    s1, s2 = _pair(200, 170, seed=4)
    got = api.align_score(s1, s2, cfg, EngineConfig(impl=impl, device="cpu", chunk_rows=32))
    assert got == joracle.score(s1, s2, jcfg)


def test_fallbacks_and_refusals_match_jax():
    """``band-strips`` under affine gaps runs ``strips``, with a matrix
    ``band``; ``strips`` and ``bitpal-strips`` under a matrix raise
    ValueError in both packages."""
    s1, s2 = _pair(90, 70, seed=9)
    for kw in (dict(match=2, mismatch=-1, gap_open=-5, gap_extend=-2),
               dict(matrix=True, gap_open=-5, gap_extend=-1)):
        cfg, jcfg = _cfgs(kw)
        got = api.align_score(s1, s2, cfg, EngineConfig(impl="band-strips", device="cpu"))
        assert got == tpualign.align_score(s1, s2, jcfg, JEngine(impl="band-strips",
                                                                 interpret=True))
    cfg, jcfg = _cfgs(dict(matrix=True, gap=-2))
    for impl in ("strips", "bitpal-strips"):
        with pytest.raises(ValueError, match="pair-scored"):
            tpualign.align_score(s1, s2, jcfg, JEngine(impl=impl, interpret=True))
        with pytest.raises(ValueError, match="pair-scored"):
            api.align_score(s1, s2, cfg, EngineConfig(impl=impl, device="cpu"))
    for bad in (0, -4):
        with pytest.raises(ValueError, match="chunk_rows must be positive"):
            JEngine(chunk_rows=bad)
        with pytest.raises(ValueError, match="chunk_rows must be positive"):
            EngineConfig(chunk_rows=bad)


@pytest.mark.parametrize("impl, module, name", [("bitpal-strips", "bitpal", "fill_g_stream"),
                                               ("band-strips", "band", "edge_fill")])
def test_a_fault_inside_a_sharded_pipeline_is_not_rerouted(monkeypatch, impl, module, name):
    """Only the envelope's refusals, found before the pipeline runs, send
    a pair to another engine: a ValueError raised by a kernel wrapper
    during the run reaches the caller."""
    from tpualign_torch.ops import band, bitpal

    def fault(*args, **kwargs):
        raise ValueError("a kernel wrapper's argument check")

    monkeypatch.setattr({"bitpal": bitpal, "band": band}[module], name, fault)
    monkeypatch.setattr(mesh, "default_group", lambda device="cuda": mesh.Group(["cpu"] * 2))
    s1, s2 = _pair(120, 100, seed=13)
    with pytest.raises(ValueError, match="argument check"):
        api.align_score(s1, s2, engine=EngineConfig(impl=impl, device="cpu"))


@pytest.mark.parametrize("impl", ["strips", "bitpal-strips"])
def test_align_with_a_sharded_name_is_checkpointed(monkeypatch, impl):
    """Past the full table a sharded name takes the checkpointed row-scan
    traceback in both packages: the same strings."""
    monkeypatch.setattr(api, "FULL_TABLE_CELL_LIMIT", 500)
    monkeypatch.setattr(japi, "FULL_TABLE_CELL_LIMIT", 500)
    s1, s2 = _pair(60, 50, seed=12)
    got = api.align(s1, s2, engine=EngineConfig(impl=impl, device="cpu"))
    assert got == tpualign.align(s1, s2, engine=JEngine(impl=impl, interpret=True))


@pytest.mark.parametrize("g", [1, 2])
def test_align_sharded_strings_match_jax(g):
    """The bisection's splits are exact integers and the leaves the C++
    walk's, so the strings are ``tpualign``'s, not merely optimal."""
    s1, s2 = _pair(180, 150 + 40 * g, seed=5 + g)
    want = jhirschberg.align_sharded(s1, s2, JScoring(gap=-g), mesh=make_mesh(4),
                                     interpret=True, base_cells=1 << 13)
    got = hirschberg.align_sharded(s1, s2, ScoringConfig(gap=-g),
                                   group=mesh.make_group(4, device="cpu"), base_cells=1 << 13)
    assert got == want


def test_align_sharded_refuses_outside_the_family():
    s1, s2 = _pair(30, 30, seed=1)
    with pytest.raises(ValueError, match="family"):
        hirschberg.align_sharded(s1, s2, ScoringConfig(mode=AlignMode.LOCAL), device="cpu")


def test_gloo_world_matches_the_in_process_group(tmp_path):
    """4 gloo ranks, a shard each: every rank returns the in-process
    group's result of every case, and the scores are ``tpualign``'s."""
    world = 4
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_dist_ranks.py"),
                               str(r), str(world), str(tmp_path / "store"), str(tmp_path)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    errs = [p.communicate(timeout=300)[1] for p in procs]
    assert all(p.returncode == 0 for p in procs), errs
    ranks = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(world)]
    assert all(r["stats"]["supersteps"] > 0 for r in ranks)
    group = mesh.make_group(world, device="cpu")
    for name, (engine, cfg, (m, n), seed, kw) in torch_dist_ranks.CASES.items():
        want = torch_dist_ranks.run(name, group)
        if isinstance(want, tuple):
            want = list(want)
        assert all(r[name] == want for r in ranks), name
        s1, s2 = torch_dist_ranks.pair(m, n, seed)
        jcfg = JScoring(match=cfg.match, mismatch=cfg.mismatch, gap=cfg.gap,
                        mode=JMode[cfg.mode.name], gap_open=cfg.gap_open,
                        gap_extend=cfg.gap_extend,
                        matrix=jmatrices.dna(2, -1, -3) if cfg.has_matrix else None)
        score = {"col_deltas": lambda: sum(want) - m, "align_sharded": lambda: want[0]}.get(
            engine, lambda: want)()
        assert score == joracle.score(s1, s2, jcfg), name
