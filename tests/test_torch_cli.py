"""The port's command line (``python -m tpualign_torch``, ``tpualign_torch.cli``)
with ``--device cpu`` against the JAX package's (``tpualign.cli.main``) on
the same ``.bdna`` files: ``score``'s and ``align``'s lines and files,
``generate``'s bytes, ``bench``'s rows, its swap rule and its checks, the
sharded engines, ``tune``, ``info``; and the port's copies of the ``.bdna``
IO and the golden pins against the JAX package's."""

import json

import numpy as np
import pytest

from tpualign import golden as jgolden
from tpualign.cli import main as jmain
from tpualign.io import bdna as jbdna
from tpualign_torch import api, golden
from tpualign_torch.cli import main
from tpualign_torch.config import AlignMode, ScoringConfig
from tpualign_torch.io import bdna
from tpualign_torch.ops import hirschberg, oracle


def _run(fn, argv, capsys):
    """``(exit code, stdout lines, stderr)`` of one CLI call."""
    rc = fn(argv)
    out = capsys.readouterr()
    return rc, out.out.splitlines(), out.err


@pytest.fixture
def pair_files(tmp_path):
    s1, s2 = jbdna.random_pair(60, 55, seed=77)
    p1, p2 = tmp_path / "a.bdna", tmp_path / "b.bdna"
    jbdna.write_bdna(p1, s1)
    jbdna.write_bdna(p2, s2)
    return str(p1), str(p2), s1, s2


SCORE_ARGS = {
    "unit": [],
    "sw": ["--mode", "sw", "--match", "2", "--mismatch", "-1", "--gap", "-2"],
    "g2 oracle": ["--gap", "-2", "--impl", "oracle"],
    "affine": ["--gap-open", "-5", "--gap-extend", "-2"],
    "dna infix": ["--matrix", "dna:2,-1,-3", "--gap", "-3", "--mode", "infix"],
}


@pytest.mark.parametrize("case", list(SCORE_ARGS))
def test_score_matches_jax_cli(pair_files, capsys, case):
    p1, p2, _, _ = pair_files
    rc, out, _ = _run(main, ["score", p1, p2, "--device", "cpu", *SCORE_ARGS[case]], capsys)
    jrc, jout, _ = _run(jmain, ["score", p1, p2, *SCORE_ARGS[case]], capsys)
    assert rc == jrc == 0
    assert len(out) == len(jout) == 2
    float(out[0])  # the call's ms
    assert out[1] == jout[1] and out[1].startswith("Score: ")


@pytest.mark.parametrize("case", ["unit", "sw"])
def test_align_matches_jax_cli_at_full_table_sizes(pair_files, tmp_path, capsys, case):
    """Below the full table both CLIs walk the oracle's table: the same
    file, the same printed blocks."""
    p1, p2, _, _ = pair_files
    args = [*SCORE_ARGS[case], "--width", "25"]
    f, jf = str(tmp_path / "aln.txt"), str(tmp_path / "jaln.txt")
    rc, out, _ = _run(main, ["align", p1, p2, "--device", "cpu", "--out", f, *args], capsys)
    jrc, jout, _ = _run(jmain, ["align", p1, p2, "--out", jf, *args], capsys)
    assert rc == jrc == 0
    assert open(f).read() == open(jf).read()
    assert out[1:] == [jout[1], f"alignment written to {f}"]
    rc, out, _ = _run(main, ["align", p1, p2, "--device", "cpu", *args], capsys)
    jrc, jout, _ = _run(jmain, ["align", p1, p2, *args], capsys)
    assert rc == jrc == 0 and out[1:] == jout[1:] and len(out) > 5


@pytest.mark.parametrize("case", ["unit", "sw"])
def test_align_past_the_full_table_is_valid_and_optimal(tmp_path, monkeypatch, capsys, case):
    """Past the full table the two packages' splits may take other ties
    (ROADMAP item 9): the port's file is a valid alignment that re-scores
    to the JAX CLI's score."""
    monkeypatch.setattr(api, "FULL_TABLE_CELL_LIMIT", 3000)
    monkeypatch.setattr(hirschberg, "BASE_CELLS", 3000)
    s1, s2 = jbdna.random_pair(300, 280, seed=5)
    p1, p2 = str(tmp_path / "a.bdna"), str(tmp_path / "b.bdna")
    jbdna.write_bdna(p1, s1)
    jbdna.write_bdna(p2, s2)
    f = str(tmp_path / "aln.txt")
    rc, out, _ = _run(main, ["align", p1, p2, "--device", "cpu", "--out", f, *SCORE_ARGS[case]],
                      capsys)
    jrc, jout, _ = _run(jmain, ["score", p1, p2, *SCORE_ARGS[case]], capsys)
    assert rc == jrc == 0 and out[1] == jout[1]
    a1, a2 = open(f).read().splitlines()
    cfg = (ScoringConfig(match=2, mismatch=-1, gap=-2, mode=AlignMode.LOCAL) if case == "sw"
           else ScoringConfig())
    assert out[1] == f"Score: {oracle.alignment_score(a1, a2, cfg)}"
    assert len(a1) == len(a2) and not any(x == y == "-" for x, y in zip(a1, a2))
    text1, text2 = bdna.decode(s1), bdna.decode(s2)
    if case == "sw":
        assert a1.replace("-", "") in text1 and a2.replace("-", "") in text2
    else:
        assert (a1.replace("-", ""), a2.replace("-", "")) == (text1, text2)


@pytest.mark.parametrize("args", [["--lengths", "100", "120", "--seed", "5"],
                                  ["--gb", "0.0001"], ["--lengths", "1", "0"]],
                         ids=["lengths", "gb", "empty"])
def test_generate_matches_jax_cli(tmp_path, capsys, args):
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    files = [str(tmp_path / d / n) for d in ("p", "j") for n in ("g1.bdna", "g2.bdna")]
    rc, out, _ = _run(main, ["generate", *files[:2], *args], capsys)
    jrc, jout, _ = _run(jmain, ["generate", *files[2:], *args], capsys)
    assert rc == jrc == 0
    assert out == [line.replace("/j/", "/p/") for line in jout]
    for ours, theirs in zip(files[:2], files[2:]):
        assert open(ours, "rb").read() == open(theirs, "rb").read()


def test_generate_needs_a_size(tmp_path, capsys):
    rc, _, err = _run(main, ["generate", str(tmp_path / "a"), str(tmp_path / "b")], capsys)
    assert rc == 2 and "pass --gb or --lengths" in err


def _corpus(tmp_path, name, m, n, seed):
    d = tmp_path / "corpus"
    d.mkdir(exist_ok=True)
    s1, s2 = jbdna.random_pair(m, n, seed=seed)
    jbdna.write_bdna(d / f"{name}-1.bdna", s1)
    jbdna.write_bdna(d / f"{name}-2.bdna", s2)
    return str(d), s1, s2


def test_bench_rows_match_jax_cli(tmp_path, capsys):
    """TSV and JSON rows: the JAX CLI's columns and scores; the port's JSON
    names its backend and device.  The infix row keeps s1 as the text
    though s2 is longer (``tests/test_cli.py:73``)."""
    corpus, s1, s2 = _corpus(tmp_path, "x", 48, 90, seed=3)
    args = ["bench", "--pairs", "x", "--corpus", corpus, "--mode", "infix", "--match", "2",
            "--mismatch", "-1", "--gap", "-2", "--runs", "1"]
    tsv, js, jtsv = (str(tmp_path / n) for n in ("o.tsv", "o.json", "j.tsv"))
    rc, out, _ = _run(main, [*args, "--device", "cpu", "--tsv", tsv, "--json", js], capsys)
    jrc, jout, _ = _run(jmain, [*args, "--impl", "xla", "--tsv", jtsv], capsys)
    assert rc == jrc == 0
    want = oracle.score(s1, s2, ScoringConfig(match=2, mismatch=-1, gap=-2,
                                              mode=AlignMode.INFIX))
    assert want != oracle.score(s2, s1, ScoringConfig(match=2, mismatch=-1, gap=-2,
                                                      mode=AlignMode.INFIX))
    rows = [line.split("\t") for line in open(tsv).read().splitlines()]
    jrows = [line.split("\t") for line in open(jtsv).read().splitlines()]
    assert rows[0] == jrows[0] and len(rows) == len(jrows) == 2
    assert int(rows[1][-1]) == int(jrows[1][-1]) == want
    assert out[0].split("\t")[-1] == jout[0].split("\t")[-1] == f"score {want}"
    payload = json.load(open(js))
    assert payload["meta"]["backend"] == payload["meta"]["device"] == "cpu"
    assert payload["meta"]["scoring"]["mode"] == "infix"
    assert [r["score"] for r in payload["results"]] == [want]


@pytest.mark.parametrize("check,name,wrong", [
    ("native", "x", False), ("native", "x", True), ("golden", "debug", False),
    ("golden", "x", True), ("off", "x", True)])
def test_bench_check_withholds_a_wrong_row(tmp_path, monkeypatch, capsys, check, name, wrong):
    """A row whose score fails ``--check`` is withheld with exit 1: a score
    made wrong on purpose under ``native``; the random stand-in named
    ``debug`` under ``golden`` (the JAX CLI withholds it too); a pair
    without a pin passes ``golden`` unchecked, and ``off`` checks nothing."""
    corpus, s1, s2 = _corpus(tmp_path, name, 50, 53, seed=9)
    if wrong:
        real = api.align_score
        monkeypatch.setattr(api, "align_score", lambda *a, **kw: real(*a, **kw) + 1)
    tsv = str(tmp_path / "o.tsv")
    argv = ["bench", "--pairs", name, "--corpus", corpus, "--runs", "1", "--check", check,
            "--tsv", tsv]
    rc, out, err = _run(main, [*argv, "--device", "cpu"], capsys)
    withheld = (check == "native" and wrong) or name == "debug"
    assert rc == (1 if withheld else 0)
    assert len(open(tsv).read().splitlines()) == (1 if withheld else 2)
    if withheld:
        pin = "native" if check == "native" else "pinned"
        assert out == [] and f"ERROR {name}: score" in err and f"!= {pin}" in err
    if name == "debug":
        jrc, _, jerr = _run(jmain, [*argv[:-2], "--impl", "xla"], capsys)
        assert jrc == 1 and jerr == err


@pytest.mark.parametrize("impl", ["bitpal-strips", "band-strips", "strips"])
@pytest.mark.parametrize("cmd", ["score", "align", "bench"])
def test_sharded_impls_are_refused(pair_files, tmp_path, capsys, cmd, impl):
    """The sharded engines, once refused, now run: ``score`` and ``bench``
    give the JAX CLI's score (its ``auto``), ``align`` its lines (the full
    table at this size, whatever the engine), with ``--chunk-rows`` read."""
    p1, p2, s1, s2 = pair_files
    if cmd == "bench":
        corpus, s1, s2 = _corpus(tmp_path, "x", 60, 55, seed=77)
        argv = ["bench", "--pairs", "x", "--corpus", corpus, "--runs", "1"]
    else:
        argv = [cmd, p1, p2]
    rc, out, _ = _run(main, [*argv, "--impl", impl, "--device", "cpu", "--chunk-rows", "16"],
                      capsys)
    jrc, jout, _ = _run(jmain, argv, capsys)
    assert rc == jrc == 0
    if cmd == "bench":
        assert out[0].split("\t")[-1] == jout[0].split("\t")[-1] == \
            f"score {oracle.score(s1, s2)}"
    else:
        assert out[1:] == jout[1:] and out[1] == f"Score: {oracle.score(s1, s2)}"


@pytest.mark.parametrize("engine, values", [("strips", "16,32"), ("bitpal", "16,32"),
                                            ("band", "1:32,8:64"), ("rc-chunk", None)])
def test_tune_rows(pair_files, tmp_path, capsys, engine, values):
    """``tune``: one row a knob value, each with the pair's score, on 3
    shards in this process for the sharded engines, the TSV beside it."""
    p1, p2, s1, s2 = pair_files
    tsv = str(tmp_path / "t.tsv")
    argv = ["tune", p1, p2, "--engine", engine, "--device", "cpu", "--devices", "3",
            "--runs", "1", "--tsv", tsv]
    argv += ["--values", values] if values else ["--rc", "1,2", "--blocks", "0,1"]
    rc, out, _ = _run(main, argv, capsys)
    assert rc == 0 and len(out) == (5 if engine == "rc-chunk" else 3)
    want = oracle.score(s1, s2)
    assert all(line.endswith(f"score {want}") for line in out[:-1])
    assert len(open(tsv).read().splitlines()) == len(out)


def test_info(capsys):
    rc, out, _ = _run(main, ["info"], capsys)
    assert rc == 0 and out[0].startswith("torch ") and "backend" in out[0]
    assert len(out) >= 2


def test_golden_pins_match_jax_package():
    assert golden.GOLDEN_NW_UNIT == jgolden.GOLDEN_NW_UNIT
    assert golden.GOLDEN_SW_2_1_2 == jgolden.GOLDEN_SW_2_1_2


@pytest.mark.parametrize("m,n,seed", [(0, 5, 0), (100, 120, 5), (1000, 7, 64)])
def test_bdna_io_matches_jax_package(tmp_path, m, n, seed):
    assert bdna.BASES == jbdna.BASES
    s1, s2 = bdna.random_pair(m, n, seed=seed)
    j1, j2 = jbdna.random_pair(m, n, seed=seed)
    assert s1.tobytes() == j1.tobytes() and s2.tobytes() == j2.tobytes()
    assert bdna.pair_lengths_for_gb(seed + 0.5) == jbdna.pair_lengths_for_gb(seed + 0.5)
    assert bdna.table_gb(m, n) == jbdna.table_gb(m, n)
    bdna.write_bdna(tmp_path / "s.bdna", s1)
    assert np.array_equal(bdna.read_bdna(tmp_path / "s.bdna"), jbdna.read_bdna(tmp_path / "s.bdna"))
    text = bdna.decode(s2)
    assert text == jbdna.decode(s2)
    assert np.array_equal(bdna.encode(text.lower()), jbdna.encode(text.lower()))


def test_bdna_io_refusals_match_jax_package(tmp_path):
    (tmp_path / "bad.bdna").write_bytes(bytes([1, 2, 7]))
    for mod in (bdna, jbdna):
        with pytest.raises(ValueError, match="byte value 7 outside .bdna code range 0..4"):
            mod.read_bdna(tmp_path / "bad.bdna")
        assert mod.read_bdna(tmp_path / "bad.bdna", validate=False).tolist() == [1, 2, 7]
        with pytest.raises(ValueError, match="codes outside 0..4"):
            mod.write_bdna(tmp_path / "o.bdna", np.asarray([0, 5], np.int8))
        with pytest.raises(ValueError, match="must be 1-D"):
            mod.write_bdna(tmp_path / "o.bdna", np.zeros((2, 2), np.int8))
        with pytest.raises(ValueError, match="not in alphabet"):
            mod.encode("ACGX")
