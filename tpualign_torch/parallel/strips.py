"""Row-scan strips over a shard group: the port of
``tpualign/parallel/strips.py``.

Shard ``c`` owns the text's column block ``[c*W, (c+1)*W)``, ``W =
ceil(m / P)`` (the last blocks shorter, or empty); the query is cut into
chunks of ``chunk`` rows, and at superstep ``t`` shard ``c`` fills chunk
``t - c`` of its block with the row scan
(:func:`tpualign_torch.ops.xla.rows_scan`), its top row the bottom row of
its own chunk above (under affine gaps F's too), its left column the right
column that shard ``c - 1`` filled one superstep earlier (the halo, under
affine gaps H and E: the horizontal gap crosses the cut, F never does).
Shard 0's left column and chunk 0's top row are the table's edges in
closed form.  ``K + P - 1`` supersteps, the reference's wavefront.

Local scoring takes the max over the shards of each shard's running max;
global scoring takes H(n, m) from the shard that owns column m.  No
kernel: the same two edges are the plain version of K7's sharded contract
(:func:`tpualign_torch.ops.band.capture_plain`).  Pair-scored global and
local configs, linear or affine (``ensure_pair_modes``), as the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ScoringConfig, ensure_pair_modes
from ..ops import xla
from ..ops.bitpal import _device
from . import mesh

NEG = xla.NEG


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def edge(cfg: ScoringConfig, lo: int, hi: int, zero: bool, device) -> torch.Tensor:
    """The closed-form table edge H(0, lo..hi) (or H(lo..hi, 0)), int64:
    0 under local scoring or ``zero``, else the gap run of each index
    (``gap * i``, affine ``open + ext * i`` and 0 at index 0)."""
    i = torch.arange(lo, hi + 1, dtype=torch.int64, device=device)
    if cfg.is_local or zero:
        return torch.zeros_like(i)
    if cfg.is_affine:
        return torch.where(i == 0, 0, cfg.gap_open + cfg.gap_extend * i)
    return i * cfg.gap


def score(s1, s2, cfg: ScoringConfig = ScoringConfig(), *, group=None,
          chunk_rows: int = 2048, device="cuda") -> int:
    """Alignment score of ``s1`` (columns, sharded) against ``s2`` (rows,
    in chunks of ``chunk_rows``) over ``group`` (default
    :func:`tpualign_torch.parallel.mesh.default_group` of ``device``), the
    row scan on each shard's device.  Refuses matrix and ends-free configs
    (ValueError), as the reference."""
    ensure_pair_modes(cfg, "strips")
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
    a, b = np.asarray(s1), np.asarray(s2)
    if a.ndim != 1 or b.ndim != 1:
        raise ValueError("sequences must be 1-D")
    m, n = int(a.size), int(b.size)
    if m == 0 or n == 0:
        return xla._empty_score(m, n, cfg)
    group = mesh.default_group(_device(device)) if group is None else group
    P = group.size
    W = -(-m // P)
    chunk = min(chunk_rows, _round_up(n, 8))
    K = -(-n // chunk)
    affine, local = cfg.is_affine, cfg.is_local
    query = torch.from_numpy(np.ascontiguousarray(b, dtype=np.int64))
    shards = {}
    for c in group.shards:
        dev = group.device(c)
        j0, j1 = min(c * W, m), min((c + 1) * W, m)
        top_f = torch.full((j1 - j0 + 1,), NEG, dtype=torch.int64, device=dev)
        shards[c] = dict(
            j0=j0, j1=j1, dev=dev,
            text=torch.from_numpy(np.ascontiguousarray(a[j0:j1], dtype=np.int64)).to(dev),
            top_h=edge(cfg, j0, j1, False, dev), top_f=top_f if affine else None,
            best=torch.tensor(NEG, device=dev))
    halo = 2 if affine else 1

    def step(c, t, got):
        sh = shards[c]
        dev = sh["dev"]
        out = torch.zeros((halo, chunk + 1), dtype=torch.int64, device=dev)
        h = t - c
        if not 0 <= h < K:
            return out
        r0, r1 = h * chunk, min((h + 1) * chunk, n)
        rows = r1 - r0
        if c == 0:
            left_h = edge(cfg, r0, r1, False, dev)
            left_e = torch.full((rows + 1,), NEG, dtype=torch.int64, device=dev)
        else:
            left_h, left_e = got[0, : rows + 1], got[-1, : rows + 1]
        if sh["j1"] == sh["j0"]:  # an empty block hands its left column on
            out[0, : rows + 1] = left_h
            out[-1, : rows + 1] = left_e
            return out
        scan = xla.rows_scan(sh["text"], query[r0:r1], cfg, zero_row=False, zero_col=False,
                             want_best=local, want_col=True, top_h=sh["top_h"],
                             top_f=sh["top_f"], left_h=left_h,
                             left_e=left_e if affine else None)
        out[0, 0] = sh["top_h"][-1]  # the corner H(r0, j1)
        out[0, 1 : rows + 1] = scan.col
        if affine:
            out[1, 0] = NEG
            out[1, 1 : rows + 1] = scan.col_e
            sh["top_f"] = scan.f
        sh["top_h"] = scan.h
        if local:
            sh["best"] = torch.maximum(sh["best"], scan.best)
        return out

    mesh.run(group, step, K + P - 1)
    if local:
        vals = [shards[c]["best"].clamp(min=0) for c in group.shards]
    else:  # H(n, m) on the shard that owns column m
        own = (m - 1) // W
        vals = [shards[c]["top_h"][-1] if c == own else torch.tensor(NEG, device=shards[c]["dev"])
                for c in group.shards]
    return int(group.max(vals))
