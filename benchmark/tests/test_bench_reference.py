"""The plain reference against the program's CPU path, and the control:
the reference in int16 fails where the scores or its row's ramp leave the
16-bit range.  Each configuration names its reference by path, and the
harness finds it there; every test of a configuration holds it to the
reference it names, and gives the program its scheme by the harness's own
rule (``harness.Port``)."""

import numpy as np
import pytest
import torch

import tpualign_torch as tt
from benchmark import harness, spec
from benchmark.reference import alignment, linear

SPEC = spec.load()
CONFIGS = [c["name"] for c in SPEC["configs"]]


def _config(name):
    return spec.workload(SPEC, next(w["name"] for w in SPEC["workloads"]
                                    if w["config"] == name)).config


def _scoring(config):
    return harness.Port(tt, config, "cpu").scoring


def _pairs(seed, count, text, query):
    rng = np.random.default_rng(seed)
    return ([rng.integers(1, 5, rng.integers(*text), dtype=np.int8) for _ in range(count)],
            [rng.integers(1, 5, rng.integers(*query), dtype=np.int8) for _ in range(count)])


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("config", CONFIGS)
def test_reference_equals_the_program_on_the_cpu(config, seed):
    cfg = _config(config)
    texts, queries = _pairs(seed, 7, (1, 900), (1, 600))
    texts.append(texts[0][:1])  # one-base pairs beside long ones
    queries.append(queries[1][:1])
    want = [tt.align_score(t, q, _scoring(cfg), tt.EngineConfig(device="cpu"))
            for t, q in zip(texts, queries)]
    got = spec.reference(cfg).scores(texts, queries, cfg, device="cpu")
    assert got.dtype == np.int64 and got.tolist() == want
    batch = tt.align_score_batch(texts, queries, _scoring(cfg), tt.EngineConfig(device="cpu"))
    assert batch.tolist() == want


@pytest.mark.parametrize("config", CONFIGS)
def test_the_control_fails_past_16_bits(config):
    """A 40-base query copied, with a few changes, from past column 16,383
    of a 40,000-base text: the global score passes -32,768 and the local
    optimum lies where the row's ramp ``T[k] - k * gap`` has passed
    32,767."""
    cfg = _config(config)
    (t1, t2), _ = _pairs(5, 2, (40_000, 40_001), (1, 2))
    q1, q2 = t1[20_000:20_040].copy(), t2[30_000:30_040].copy()
    q1[::9], q2[::11] = q1[::9] % 4 + 1, q2[::11] % 4 + 1
    texts, queries = [t1, t2], [q1, q2]
    reference = spec.reference(cfg)
    exact = reference.scores(texts, queries, cfg, device="cpu")
    low = reference.scores(texts, queries, cfg, device="cpu", dtype=torch.int16)
    want = [tt.align_score(t, q, _scoring(cfg), tt.EngineConfig(device="cpu"))
            for t, q in zip(texts, queries)]
    assert exact.tolist() == want
    assert (low != exact).all()


def test_the_reference_refuses_other_schemes():
    with pytest.raises(ValueError):
        linear.Scheme.from_config(dict(mode="infix", match=2, mismatch=-1, gap=-2))
    with pytest.raises(ValueError):
        linear.Scheme.from_config(dict(mode="global", match=2, mismatch=-1, gap=-2,
                                       gap_open=-5))
    with pytest.raises(ValueError):
        linear.Scheme.from_config(dict(mode="global", match=2, mismatch=-1, gap=-2,
                                       matrix=[[0, 1], [1, 0]]))


@pytest.mark.parametrize("config", CONFIGS)
def test_the_configuration_names_its_reference(config):
    """The path resolves to a module under ``benchmark/reference/`` that
    gives the harness both functions, and every cell of the configuration
    gets that same module."""
    cfg = _config(config)
    reference = spec.reference(cfg)
    assert reference.__name__ == "benchmark.reference." + cfg["reference"].split("/")[-1][:-3]
    assert callable(reference.scores) and callable(reference.fault)
    cells = [w["name"] for w in SPEC["workloads"] if w["config"] == config]
    assert cells and all(spec.workload(SPEC, w).reference is reference for w in cells)


@pytest.mark.parametrize("path", ["benchmark/reference/none.py", "benchmark/harness.py",
                                  "/abs/benchmark/reference/linear.py",
                                  "benchmark/reference/../harness.py",
                                  "benchmark/reference/linear"])
def test_a_reference_path_outside_the_folder_is_refused(path):
    with pytest.raises(ValueError):
        spec.reference(dict(reference=path))


@pytest.mark.parametrize("seed", range(3))
def test_alignment_check(seed, monkeypatch):
    cfg = _config("sw-2-1-2")
    (s1, s2), _ = _pairs(seed, 2, (300, 400), (1, 2))
    s2 = s1[40:260].copy()
    s2[::7] = s2[::7] % 4 + 1
    score, a1, a2 = tt.align(s1, s2, _scoring(cfg), tt.EngineConfig(device="cpu"))
    best = int(linear.scores([s1], [s2], cfg, device="cpu")[0])
    assert score == best and linear.fault(s1, s2, a1, a2, cfg, best) is None
    k = a1.index("A") if "A" in a1 else 0
    assert linear.fault(s1, s2, a1[:k] + "C" + a1[k + 1:], a2, cfg, best)
    assert linear.fault(s1, s2, a1 + "-", a2 + "-", cfg, best)
    assert linear.fault(s1, s2, a1, a2, cfg, best + 1)
    assert linear.fault(s1, s2, a1[1:], a2[1:], cfg, best)
    g = _config("nw-unit")
    score, a1, a2 = tt.align(s1, s2, _scoring(g), tt.EngineConfig(device="cpu"))
    assert linear.fault(s1, s2, a1, a2, g, score) is None
    assert linear.fault(s1[1:], s2, a1, a2, g, score)
    # the strings' check is the scheme's own: a column scorer of another scheme
    assert alignment.fault(s1, s2, a1, a2, local=False, value=lambda c1, c2: score,
                           optimum=score) is None
    assert alignment.fault(s1, s2, a1, a2, local=False, value=lambda c1, c2: score - 1,
                           optimum=score)


@pytest.mark.cuda
@pytest.mark.parametrize("config", CONFIGS)
def test_graphs_on_the_card_equal_the_cpu(config, cuda_device):
    cfg = _config(config)
    reference = spec.reference(cfg)
    texts, queries = _pairs(9, 5, (1, 3000), (1, 700))
    cpu = reference.scores(texts, queries, cfg, device="cpu")
    card = reference.scores(texts, queries, cfg, device=cuda_device)
    assert card.tolist() == cpu.tolist()
    low = reference.scores(texts, queries, cfg, device=cuda_device, dtype=torch.int16)
    assert low.tolist() == reference.scores(texts, queries, cfg, device="cpu",
                                            dtype=torch.int16).tolist()
