"""The strip kernel over a shard group: the port of
``tpualign/parallel/band_strips.py``.

Orientation, kernel config and flags are ``band.plan``'s: the text (the
longer sequence, the strips' columns) is cut into column blocks, shard
``c`` owning ``[c*W, (c+1)*W)``, ``W = ceil(mb / P)`` (the last blocks
shorter, or empty, and then handing their left column on); the query is
cut into chunks of ``chunk_rows`` rows.  At superstep ``t`` shard ``c``
fills chunk ``t - c`` of its block with one launch of K7's sharded
contract (:func:`tpualign_torch.ops.band.edge_fill`,
``csrc/band_capture_edge.cu``): its top row is its own bottom row of the
chunk above (carried on the shard), its left column the right column that
shard ``c - 1`` captured one superstep earlier (shifted in), each with the
corner; shard 0's left column and chunk 0's top row are the table's edges
in closed form.  The launch returns the chunk's last row (the next top
row), its right column (shifted to shard ``c + 1``) and, local, its
located cell (the chunk's max).

Scores: local, the max over the shards of the chunks' maxima (and 0);
ends-free, the max over the last row's real columns (``er``) and over the
owner of the last column's right columns (``ec``), with ``band.plan``'s
closed-form boundary cells; otherwise H(n, m) on the owner of column m.

The chunk depth, :data:`CHUNK_ROWS`, is the port's own knob in place of the
TPU's ``rows=28`` strips: one launch a chunk, each a pipelined fill of
strips over many blocks.  What the reference serves is served: NW under
any parameters, SW, matrices (transposed when swapped), semiglobal and
infix; affine gaps are refused (ValueError), as there.  Its TPU-only
refusals (a column block past ``MAX_BOUNDARY``, masked SW) are not: the
port serves them, with the oracle's scores.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import ScoringConfig
from ..ops import band, xla
from ..ops.bitpal import _device
from ..ops.pairs import int8_codes
from . import mesh
from .strips import edge

#: query rows a chunk: one launch of the sharded capture fill, 16 strips
#: of the planner's 1,024 rows (k = 8, 128 threads) at the 64gb shape
CHUNK_ROWS = 16384


def check(s1, s2, cfg: ScoringConfig):
    """The pair's int8 codes, or ValueError where :func:`score` refuses it
    before it runs: affine gaps (degenerate lengths included), codes that
    do not fit int8 or the matrix, a non-empty pair past the int32
    headroom."""
    if cfg.is_affine:
        raise ValueError("affine gaps are outside the sharded band engine's envelope; "
                         "use impl='xla' (or 'oracle')")
    a, b = int8_codes(s1), int8_codes(s2)
    xla.check_codes(torch.from_numpy(a), torch.from_numpy(b), cfg)
    if a.size and b.size:
        band._check_cfg(cfg, int(a.size + b.size))
    return a, b


def score(s1, s2, cfg: ScoringConfig = ScoringConfig(), *, group=None,
          chunk_rows: Optional[int] = None, device="cuda") -> int:
    """Alignment score with the text axis sharded over ``group`` (default
    :func:`tpualign_torch.parallel.mesh.default_group` of ``device``) and
    K7's sharded contract filling each shard's chunks of ``chunk_rows``
    query rows (default :data:`CHUNK_ROWS`)."""
    chunk_rows = CHUNK_ROWS if chunk_rows is None else chunk_rows
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
    a, b = check(s1, s2, cfg)
    m, n = int(a.size), int(b.size)
    if m == 0 or n == 0:
        return band._empty_score(m, n, cfg)
    p = band.plan(m, n, cfg)
    text, query = (b, a) if p.swapped else (a, b)
    mb, ns = text.size, query.size
    zr, zc, er, ec = p.ends
    local = cfg.is_local
    group = mesh.default_group(_device(device)) if group is None else group
    P = group.size
    W = -(-mb // P)
    chunk = min(chunk_rows, ns)
    K = -(-ns // chunk)
    own = (mb - 1) // W  # the shard of the last column
    shards = {}
    for c in group.shards:
        dev = group.device(c)
        j0, j1 = min(c * W, mb), min((c + 1) * W, mb)
        shards[c] = dict(dev=dev, j0=j0, j1=j1,
                         text=torch.from_numpy(text[j0:j1]).to(dev),
                         query=torch.from_numpy(query).to(dev),
                         top=edge(p.cfg, j0, j1, zr, dev).int(),
                         best=torch.tensor(band.NEG, dtype=torch.int32, device=dev))

    def step(c, t, got):
        sh = shards[c]
        dev = sh["dev"]
        out = torch.zeros(chunk + 1, dtype=torch.int32, device=dev)
        h = t - c
        if not 0 <= h < K:
            return out
        r0, r1 = h * chunk, min((h + 1) * chunk, ns)
        left = edge(p.cfg, r0, r1, zc, dev).int() if c == 0 else got[: r1 - r0 + 1]
        if sh["j1"] == sh["j0"]:  # an empty block hands its left column on
            out[: r1 - r0 + 1] = left
            return out
        cap = band.edge_fill(sh["text"], sh["query"][r0:r1], p.cfg, sh["top"], left, cell=local)
        sh["top"] = cap.row
        out[: r1 - r0 + 1] = cap.col
        if local:
            sh["best"] = torch.maximum(sh["best"], cap.cell[0])
        elif ec and c == own:  # the last column, rows r0+1 .. r1
            sh["best"] = torch.maximum(sh["best"], cap.col[1:].max())
        return out

    mesh.run(group, step, K + P - 1)
    vals = []
    for c in group.shards:
        sh = shards[c]
        v = torch.tensor(band.NEG, dtype=torch.int32, device=sh["dev"])
        if local:
            v = sh["best"].clamp(min=0)
        elif er or ec:
            if er and sh["j1"] > sh["j0"]:  # the last row's columns j0+1 .. j1
                v = torch.maximum(v, sh["top"][1:].max())
            if ec and c == own:
                v = torch.maximum(v, sh["best"])
        elif c == own:  # H(n, m)
            v = sh["top"][-1]
        vals.append(v)
    out = int(group.max(vals))
    return max((out,) + p.floor) if p.floor else out
