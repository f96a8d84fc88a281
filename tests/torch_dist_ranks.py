"""One rank of a ``torch.distributed`` world (gloo, a file store) running
the port's sharded pipelines over its default group, one shard a rank.

    python tests/torch_dist_ranks.py RANK WORLD STORE_FILE OUT_DIR

Writes ``OUT_DIR/rank{RANK}.json``: each case's result, keyed by name
(:data:`CASES`).  ``tests/test_torch_api_sharded.py`` starts the ranks and
holds every rank's results against the in-process group's and
``tpualign``'s.  Imports neither ``jax`` nor ``tpualign``: the ranks run
the port alone.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from tpualign_torch import matrices  # noqa: E402
from tpualign_torch.config import AlignMode, ScoringConfig  # noqa: E402
from tpualign_torch.ops import hirschberg  # noqa: E402
from tpualign_torch.parallel import band_strips, bitpal_strips, mesh, strips  # noqa: E402


def pair(m: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    return rng.integers(1, 5, m).astype(np.int8), rng.integers(1, 5, n).astype(np.int8)


SW = ScoringConfig(match=2, mismatch=-1, gap=-2, mode=AlignMode.LOCAL)

#: name -> (engine, scoring, lengths, seed, keyword arguments)
CASES = {
    "strips nw": ("strips", ScoringConfig(), (150, 130), 1, dict(chunk_rows=16)),
    "strips sw": ("strips", SW, (140, 120), 2, dict(chunk_rows=24)),
    "strips affine": ("strips", ScoringConfig(match=2, mismatch=-1, gap_open=-5, gap_extend=-2),
                      (120, 150), 3, dict(chunk_rows=16)),
    "band sw": ("band_strips", SW, (160, 140), 4, dict(chunk_rows=32)),
    "band infix dna": ("band_strips", ScoringConfig(matrix=matrices.dna(2, -1, -3), gap=-2,
                                                    mode=AlignMode.INFIX),
                       (170, 90), 5, dict(chunk_rows=16)),
    "bitpal g1": ("bitpal_strips", ScoringConfig(), (150, 700), 6, dict(chunk_cols=40)),
    "bitpal g2": ("bitpal_strips", ScoringConfig(gap=-2), (300, 520), 7, dict(chunk_cols=64)),
    "col deltas": ("col_deltas", ScoringConfig(), (120, 530), 8, dict(chunk_cols=32)),
    "align sharded": ("align_sharded", ScoringConfig(), (150, 140), 9, dict(base_cells=1 << 11)),
}


def run(name: str, group):
    """The result of case ``name`` over ``group``, as JSON-able values."""
    engine, cfg, (m, n), seed, kw = CASES[name]
    s1, s2 = pair(m, n, seed)
    if engine == "col_deltas":
        return bitpal_strips.col_deltas_fn(m, n, cfg, group=group, **kw)(s1, s2).tolist()
    if engine == "align_sharded":
        return list(hirschberg.align_sharded(s1, s2, cfg, group=group, **kw))
    mod = dict(strips=strips, band_strips=band_strips, bitpal_strips=bitpal_strips)[engine]
    return mod.score(s1, s2, cfg, group=group, device="cpu", **kw)


def main() -> None:
    rank, world, store_file, out_dir = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                        sys.argv[4])
    store = dist.FileStore(store_file, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        group = mesh.default_group("cpu")
        assert isinstance(group, mesh.DistGroup) and group.size == world
        out = {name: run(name, group) for name in CASES}
        out["stats"] = group.stats
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    torch.set_num_threads(1)
    main()
