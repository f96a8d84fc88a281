"""Command line of the port, ``python -m tpualign_torch``: the counterpart of
``tpualign/cli.py``, with its arguments, defaults, printed lines and exit
codes.

- ``score``    — print the call's ms, then ``Score: N`` (the lines the
                 reference's serial binary prints), any engine, any
                 scoring.
- ``align``    — the same, then the alignment: to ``--out`` as two lines,
                 else in blocks of ``--width`` columns.
- ``generate`` — write a random ``.bdna`` pair by lengths or by int32
                 DP-table footprint, the bytes ``tpualign generate`` writes.
- ``bench``    — corpus pairs -> TSV/JSON rows; a row whose score fails
                 ``--check golden|native`` is withheld (exit 1).
- ``tune``     — sweep an engine's knob on a pair: the sharded engines'
                 chunk depth on the default shard group (``strips``,
                 ``bitpal``), as ``tpualign``'s; the port's own knobs for
                 the single-device fills (``rc-chunk``: the staggered
                 fill's blocks at each columns-a-step; ``band``: the strip
                 pipeline's rows a thread x threads).
- ``info``     — torch's and CUDA's versions and each device's name.

The port adds ``--device`` (default ``cuda``), as ``EngineConfig`` has:
the CLI runs on the card unless it is asked for the CPU.  ``score`` and
``align`` take ``--trace FILE``: the call runs inside
:func:`tpualign_torch.trace.recording`, and FILE gets its spans and
counters as JSON (:func:`_write_trace`).  ``--impl`` takes
``tpualign``'s names, the sharded engines' included (over the default
shard group, ``--chunk-rows`` their chunk depth).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from typing import List

import numpy as np

from . import trace
from .config import AlignMode, EngineConfig, ScoringConfig


def _scoring(args) -> ScoringConfig:
    matrix = None
    if getattr(args, "matrix", None):
        from . import matrices

        matrix = matrices.parse(args.matrix)
    return ScoringConfig(
        match=args.match,
        mismatch=args.mismatch,
        gap=args.gap,
        mode=AlignMode(args.mode),
        gap_open=getattr(args, "gap_open", None),
        gap_extend=getattr(args, "gap_extend", None),
        matrix=matrix,
    )


def _add_scoring_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--mode", choices=[m.value for m in AlignMode],
                   default="nw",
                   help="nw = global, sw = local (Smith-Waterman), "
                        "sg = semiglobal/ends-free, infix = fit the second "
                        "sequence inside the first")
    p.add_argument("--match", type=int, default=1)
    p.add_argument("--mismatch", type=int, default=0)
    p.add_argument("--gap", type=int, default=-1)
    p.add_argument("--gap-open", type=int, default=None,
                   help="affine (Gotoh) gaps: a run of L gap columns costs "
                        "gap_open + L*gap_extend (overrides --gap; set "
                        "both affine flags together)")
    p.add_argument("--gap-extend", type=int, default=None)
    p.add_argument("--matrix", type=str, default=None,
                   help="substitution matrix: 'dna:match,transition,"
                        "transversion' or explicit rows 'r00,r01,../r10,..' "
                        "indexed by .bdna code (overrides --match/--mismatch)")


def _add_engine_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--impl",
                   choices=["auto", "bitpal", "band", "band-chunked",
                            "pallas", "xla", "oracle", "bitpal-strips",
                            "band-strips", "strips"],
                   default="auto")
    p.add_argument("--chunk-rows", type=int, default=2048,
                   help="pipelined chunk depth for the sharded engine")
    p.add_argument("--device", default="cuda",
                   help="torch device the engines run on: 'cuda' (default) "
                        "runs the kernels, 'cpu' their plain versions")


def _add_trace_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--trace", metavar="FILE", default=None,
                   help="write the call's spans and counters (tpualign_torch.trace) to FILE "
                        "as JSON")


def _engine(args) -> EngineConfig:
    return EngineConfig(impl=args.impl, device=args.device, chunk_rows=args.chunk_rows)


def _load_pair(args):
    from .io.bdna import read_bdna

    return read_bdna(args.seq1), read_bdna(args.seq2)


def _traced(args):
    """The recording of the command's call under ``--trace``, else
    nothing."""
    return trace.recording() if args.trace else contextlib.nullcontext()


def _write_trace(path: str, counters_before: dict) -> None:
    """``path`` gets the recorded calls (:meth:`tpualign_torch.trace.Call.as_dict`:
    each span's name, its parent's index, its host-clock nanoseconds and
    attributes; the call's counters) and the counters the command moved."""
    now = trace.counters()
    moved = {k: v - counters_before.get(k, 0) for k, v in now.items()
             if v != counters_before.get(k, 0)}
    with open(path, "w") as f:
        json.dump({"calls": [c.as_dict() for c in trace.take()], "counters": moved}, f,
                  indent=1)
        f.write("\n")


def cmd_score(args) -> int:
    from .api import align_score

    s1, s2 = _load_pair(args)
    engine = _engine(args)
    before = trace.counters()
    with _traced(args):
        t0 = time.perf_counter()
        score = align_score(s1, s2, _scoring(args), engine)
        ms = (time.perf_counter() - t0) * 1e3
    print(f"{ms:.2f}")
    print(f"Score: {score}")
    if args.trace:
        _write_trace(args.trace, before)
    return 0


def cmd_align(args) -> int:
    from .api import align

    s1, s2 = _load_pair(args)
    engine = _engine(args)
    before = trace.counters()
    with _traced(args):
        t0 = time.perf_counter()
        score, a1, a2 = align(s1, s2, _scoring(args), engine)
        ms = (time.perf_counter() - t0) * 1e3
    if args.trace:
        _write_trace(args.trace, before)
    print(f"{ms:.2f}")
    print(f"Score: {score}")
    if args.out:
        with open(args.out, "w") as f:
            f.write(a1 + "\n" + a2 + "\n")
        print(f"alignment written to {args.out}")
    else:
        width = args.width
        for off in range(0, len(a1), width):
            x, y = a1[off : off + width], a2[off : off + width]
            mid = "".join("|" if a == b and a != "-" else " " for a, b in zip(x, y))
            print(x)
            print(mid)
            print(y)
            print()
    return 0


def cmd_generate(args) -> int:
    from .io.bdna import pair_lengths_for_gb, random_pair, table_gb, write_bdna

    if args.gb is not None:
        l1, l2 = pair_lengths_for_gb(args.gb)
    elif args.lengths:
        l1, l2 = args.lengths
    else:
        print("error: pass --gb or --lengths", file=sys.stderr)
        return 2
    s1, s2 = random_pair(l1, l2, seed=args.seed)
    write_bdna(args.out1, s1)
    write_bdna(args.out2, s2)
    print(f"wrote {args.out1} ({l1} bases), {args.out2} ({l2} bases); "
          f"table {table_gb(l1, l2):.2f} GB")
    return 0


def _bench_one(name: str, s1, s2, scoring: ScoringConfig, engine: EngineConfig, runs: int):
    """One bench row: ``align_score`` of the pair, timed by
    :func:`tpualign_torch.bench.time_call`."""
    from .api import align_score
    from .bench import time_call

    # longer-first, as tpualign's bench, but only where the swap keeps the
    # problem: infix ("fit all of s2 inside s1") and asymmetric matrices
    # score a different problem after a swap
    swap_safe = scoring.mode is not AlignMode.INFIX and (
        scoring.matrix is None
        or scoring.matrix == tuple(zip(*scoring.matrix))
    )
    if swap_safe and len(s2) > len(s1):
        s1, s2 = s2, s1
    return time_call(lambda: align_score(s1, s2, scoring, engine), label=name,
                     cells=len(s1) * len(s2), device=engine.device, runs=runs)


def _check_bench_score(name, s1, s2, scoring, score, mode: str):
    """Score cross-check of a bench row: ``golden`` compares with the pinned
    score where one exists for this pair and config; ``native`` recomputes
    it with the independent C++ scorer (any config, O(NM)).  Returns an
    error string, or None if the row is valid."""
    if mode == "off":
        return None
    if mode == "golden":
        from .golden import GOLDEN_NW_UNIT, GOLDEN_SW_2_1_2

        sw_cfg = ScoringConfig(match=2, mismatch=-1, gap=-2, mode=AlignMode.LOCAL)
        if scoring == ScoringConfig() and name in GOLDEN_NW_UNIT:
            want = GOLDEN_NW_UNIT[name]
        elif scoring == sw_cfg and name in GOLDEN_SW_2_1_2:
            want = GOLDEN_SW_2_1_2[name]
        else:
            return None  # no pin applies; the row passes unchecked
    else:  # native
        from .utils import native

        want = native.score(s1, s2, scoring)
    if score != want:
        return (
            f"{name}: score {score} != {'pinned' if mode == 'golden' else 'native'}"
            f" {want} — row withheld"
        )
    return None


def cmd_bench(args) -> int:
    from .bench import write_json, write_tsv
    from .io.bdna import read_bdna

    engine = _engine(args)
    results = []
    bad = 0
    for name in args.pairs.split(","):
        p1 = os.path.join(args.corpus, f"{name}-1.bdna")
        p2 = os.path.join(args.corpus, f"{name}-2.bdna")
        if not os.path.exists(p1):
            p1 = os.path.join(args.corpus, f"{name}1.bdna")
            p2 = os.path.join(args.corpus, f"{name}2.bdna")
        s1, s2 = read_bdna(p1), read_bdna(p2)
        r = _bench_one(name, s1, s2, _scoring(args), engine, args.runs)
        err = _check_bench_score(name, s1, s2, _scoring(args), r.score, args.check)
        if err:
            print(f"ERROR {err}", file=sys.stderr)
            bad += 1
            continue
        print(f"{r.label}\t{r.row()['ms_avg']} ms\t{r.row()['gcups_best']} GCUPS"
              f"\tscore {r.score}")
        results.append(r)
    if args.tsv:
        write_tsv(args.tsv, results)
    if args.json:
        import torch

        dev = torch.device(engine.device)
        sc = _scoring(args)
        write_json(args.json, results, {
            "backend": dev.type,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "impl": args.impl, "runs": args.runs,
            # the scoring config, so that a reader knows which problem the
            # scores belong to
            "scoring": {
                "match": sc.match, "mismatch": sc.mismatch, "gap": sc.gap,
                "mode": sc.mode.value,
                "matrix": getattr(args, "matrix", None) or None,
                "gap_open": sc.gap_open, "gap_extend": sc.gap_extend,
            },
        })
    return 1 if bad else 0


def _tune_rows(args, header: str, rows) -> None:
    if args.tsv:
        with open(args.tsv, "w") as f:
            f.write(header + "\n")
            for row in rows:
                f.write("\t".join(str(v) for v in row) + "\n")
        print(f"wrote {args.tsv}")


def cmd_tune_rc_chunk(args, s1, s2) -> int:
    """The staggered fill's blocks (``bitpal.wave_plan``) at each columns a
    step of ``--rc`` (the family's g = 1 only past 1): the port's own knob
    in place of ``tpualign``'s ``cols_per_step x chunk chars``.  The
    longer sequence is the text, as ``tpualign``'s tuner has it; the fill
    runs in chunks of ``bitpal.chunk_steps`` steps, a block count of 0 the
    planner's."""
    import torch

    from .bench import time_call
    from .ops import bitpal

    if len(s2) > len(s1):
        s1, s2 = s2, s1
    scoring = _scoring(args)
    fam = bitpal.family(scoring)
    if fam is None:
        print("error: rc-chunk tunes the (1, 0, -g) family", file=sys.stderr)
        return 2
    g = fam[1]
    dev = torch.device(args.device)
    text = torch.from_numpy(bitpal._codes(s1)).to(dev)
    nq = len(s2)
    eq = bitpal._eq_planes(torch.from_numpy(bitpal._codes(s2)).to(dev), nq)
    nw, mt = eq.shape[1], len(s1)
    rows = []
    for rc in (int(v) for v in args.rc.split(",")):
        if rc > 1 and g > 1:
            continue
        total = bitpal.total_steps(mt, nw, rc)
        t_steps = bitpal.chunk_steps(rc)
        for blocks in (int(v) for v in args.blocks.split(",")):

            def run():
                state = bitpal.init_state(nw, g, dev)
                for t0 in range(0, total, t_steps):
                    steps = min(t_steps, total - t0)
                    if rc > 1:
                        state = bitpal.fill_rc_chunk(text, eq, nq, rc, t0, steps, state,
                                                     blocks or None)
                    else:
                        state = bitpal.fill_g_chunk(text, eq, nq, g, t0, steps, state,
                                                    blocks or None)
                unit = int(bitpal._reduce_score(state.planes, nq, mt, g))
                return bitpal._from_unit(scoring, mt + nq, unit)

            r = time_call(run, label=f"rc{rc}/b{blocks}", cells=mt * nq, device=dev,
                          runs=args.runs)
            print(f"rc={rc}\tblocks={blocks}\t{r.wall_s_best*1e3:.2f} ms\t"
                  f"{r.gcups_best:.3f} GCUPS\tscore {r.score}")
            rows.append((rc, blocks, round(r.wall_s_best * 1e3, 3), round(r.gcups_best, 3),
                         r.score))
    _tune_rows(args, "rc\tblocks\tms_best\tgcups\tscore", rows)
    return 0


def cmd_tune_band(args, s1, s2) -> int:
    """The strip pipeline's geometry, rows a thread x threads
    (``band.pipeline_geometry``'s knobs, ``tools/sweep_band_pipeline.py``'s
    grid) from ``--values`` as ``K:THREADS`` (``band-chunked``: the same,
    the port's band engine having no chunked tier): the port's own knob in
    place of ``tpualign``'s ``rows``.  One ``band_fill`` a run, in
    ``band.plan``'s orientation."""
    import torch

    from .bench import time_call
    from .ops import band

    scoring = _scoring(args)
    p = band.plan(len(s1), len(s2), scoring)
    text, query = (s2, s1) if p.swapped else (s1, s2)
    dev = torch.device(args.device)
    t = torch.from_numpy(np.ascontiguousarray(text, dtype=np.int8)).to(dev)
    q = torch.from_numpy(np.ascontiguousarray(query, dtype=np.int8)).to(dev)
    rows = []
    for value in args.values.split(","):
        k, threads = (int(v) for v in value.split(":"))

        def run():
            res = int(band.band_fill(t, q, p.cfg, p.ends, (k, threads)))
            return max((res,) + p.floor)

        r = time_call(run, label=f"k{k}/t{threads}", cells=len(s1) * len(s2), device=dev,
                      runs=args.runs)
        print(f"k={k}\tthreads={threads}\t{r.wall_s_best*1e3:.2f} ms\t"
              f"{r.gcups_best:.3f} GCUPS\tscore {r.score}")
        rows.append((k, threads, round(r.wall_s_best * 1e3, 3), round(r.gcups_best, 3),
                     r.score))
    _tune_rows(args, "k\tthreads\tms_best\tgcups\tscore", rows)
    return 0


#: ``tune``'s default ``--values`` for each engine
TUNE_VALUES = {"strips": "256,512,1024,2048,4096", "bitpal": "256,512,1024,2048,4096",
               "band": "4:128,8:64,8:128,16:64,16:128",
               "band-chunked": "4:128,8:64,8:128,16:64,16:128"}


def cmd_tune(args) -> int:
    """Sweep a sharded engine's chunk depth on the default shard group
    (``--devices`` shards in this process when positive), as
    ``tpualign``'s ``tune``, or the port's own knobs (``rc-chunk``,
    ``band``)."""
    from .io.bdna import read_bdna
    from .parallel import bitpal_strips, mesh, strips

    s1, s2 = read_bdna(args.seq1), read_bdna(args.seq2)
    if args.values is None:
        args.values = TUNE_VALUES.get(args.engine, "")
    if args.engine == "rc-chunk":
        return cmd_tune_rc_chunk(args, s1, s2)
    if args.engine in ("band", "band-chunked"):
        return cmd_tune_band(args, s1, s2)
    from .bench import time_call

    group = mesh.make_group(args.devices if args.devices > 0 else None, device=args.device)
    rows = []
    for chunk in (int(v) for v in args.values.split(",")):
        if args.engine == "bitpal":
            fn = bitpal_strips.score_fn(len(s1), len(s2), _scoring(args), group=group,
                                        chunk_cols=chunk)

            def run():
                return fn(s1, s2)
        else:
            def run():
                return strips.score(s1, s2, _scoring(args), group=group, chunk_rows=chunk)
        r = time_call(run, label=str(chunk), cells=len(s1) * len(s2), device=args.device,
                      runs=args.runs)
        print(f"chunk={chunk}\t{r.wall_s_best*1e3:.2f} ms\t{r.gcups_best:.3f} GCUPS\t"
              f"score {r.score}")
        rows.append((chunk, f"{r.wall_s_best*1e3:.2f}", f"{r.gcups_best:.3f}", r.score))
    _tune_rows(args, "chunk\tms_best\tgcups\tscore", rows)
    return 0


def cmd_info(args) -> int:
    import torch

    cuda = torch.cuda.is_available()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"backend {'cuda' if cuda else 'cpu'}")
    for i in range(torch.cuda.device_count() if cuda else 0):
        print(f"  cuda:{i} {torch.cuda.get_device_name(i)}")
    if not cuda:
        print("  cpu")
    return 0


def main(argv: List[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpualign_torch", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("score", help="alignment score of two .bdna files")
    p.add_argument("seq1")
    p.add_argument("seq2")
    _add_trace_arg(p)
    _add_scoring_args(p)
    _add_engine_args(p)
    p.set_defaults(fn=cmd_score)

    p = sub.add_parser("align", help="score + alignment")
    p.add_argument("seq1")
    p.add_argument("seq2")
    p.add_argument("--out", help="write alignment to file")
    p.add_argument("--width", type=int, default=80)
    _add_trace_arg(p)
    _add_scoring_args(p)
    _add_engine_args(p)
    p.set_defaults(fn=cmd_align)

    p = sub.add_parser("generate", help="synthesize a .bdna pair")
    p.add_argument("out1")
    p.add_argument("out2")
    p.add_argument("--gb", type=float, help="target int32 DP-table footprint")
    p.add_argument("--lengths", type=int, nargs=2, metavar=("L1", "L2"))
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_generate)

    p = sub.add_parser("bench", help="size sweep -> TSV/JSON")
    p.add_argument("--pairs", default="2gb,8gb,16gb,32gb,64gb")
    p.add_argument("--corpus", default="bdna",
                   help="directory of the corpus pairs, NAME-1.bdna and "
                        "NAME-2.bdna or NAME1.bdna and NAME2.bdna")
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--tsv")
    p.add_argument("--json")
    p.add_argument("--check", choices=["golden", "native", "off"],
                   default="golden",
                   help="score cross-check per row: 'golden' = reference "
                        "binary pins (default), 'native' = independent C++ "
                        "scorer (any config), 'off' = none")
    _add_scoring_args(p)
    _add_engine_args(p)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("tune", help="sweep engine tuning knobs")
    p.add_argument("seq1")
    p.add_argument("seq2")
    p.add_argument("--engine", choices=["strips", "bitpal", "rc-chunk", "band", "band-chunked"],
                   default="strips",
                   help="sharded chunk depth (strips/bitpal) on the default shard group, "
                        "the staggered fill's blocks x columns a step (rc-chunk), or the "
                        "strip pipeline's rows a thread x threads (band)")
    p.add_argument("--values", default=None,
                   help="chunk depths (strips, bitpal; default 256,...,4096) or K:THREADS "
                        "geometries (band)")
    p.add_argument("--rc", default="1,2,3,4", help="columns a step for --engine rc-chunk")
    p.add_argument("--blocks", default="0,1,2,4",
                   help="blocks of a launch for --engine rc-chunk (0: the planner's)")
    p.add_argument("--devices", type=int, default=0,
                   help="shards in this process (0: the default shard group)")
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--tsv")
    p.add_argument("--device", default="cuda",
                   help="torch device the engines run on: 'cuda' (default) or 'cpu'")
    _add_scoring_args(p)
    p.set_defaults(fn=cmd_tune)

    p = sub.add_parser("info", help="torch, CUDA and device info")
    p.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)
    return args.fn(args)
