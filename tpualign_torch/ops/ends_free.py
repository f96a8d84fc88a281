"""Alignment past the full table for substitution matrices and the ends-free
modes (semiglobal, infix), linear or affine gaps: the port of
``tpualign/ops/ends_free.py:align_large``.

Global and local configs go to ``ops/band_align.py`` (:func:`align_global`,
:func:`align_local`), or under affine gaps to ``ops/affine_align.py``
(:func:`align`, :func:`align_local`).  The ends-free modes reduce to a
global core, as in the JAX package:

1. the end cell: one capture fill under the mode's free-start boundaries,
   the extraction set of ``tpualign.utils.native.locate_flex``
   (:func:`tpualign_torch.ops.band_align.locate_flex_device`, which is
   also the port of ``tpualign.ops.affine_align.locate_flex``);
2. the start cell: the same on the reversed prefixes ``s1[:je]``,
   ``s2[:ie]`` under global boundaries (anchored), so every path ends at
   the end cell and the extraction set scans the legal starts;
3. the global alignment of the core between them (the band split, or
   Myers-Miller under affine gaps).

Like the local paths, the returned strings cover the aligned core only.
An infix end in column 0 returns the query against gaps, as the oracle
walks, where ``tpualign`` returns empty strings (ROADMAP queue 3).
Dropped: the off-device fallback (``_device_path_ok``, and
``_align_global_matrix`` over ``native.last_row_flex``), which the JAX
package took off the TPU and when the band split refused a core; the
port's split refuses none, and its fills run on the CPU as well.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..config import AlignMode, ScoringConfig
from . import affine_align, band_align, oracle


def align_large(s1, s2, cfg: ScoringConfig, *, device,
                stats: dict | None = None) -> Tuple[int, str, str]:
    """Score plus aligned core strings of ``s1`` (columns) against ``s2``
    (rows) for a matrix or ends-free config past the full table, on
    ``device`` (module docstring).  ``stats`` goes to the global or local
    path or, for the ends-free modes, to the core's split."""
    s1 = np.asarray(s1, dtype=np.int8)
    s2 = np.asarray(s2, dtype=np.int8)
    m, n = int(s1.size), int(s2.size)
    if m == 0 or n == 0:
        return oracle.traceback(s1, s2, cfg)
    if cfg.is_affine:
        align_global, align_local = affine_align.align, affine_align.align_local
    else:
        align_global, align_local = band_align.align_global, band_align.align_local
    if cfg.mode is AlignMode.GLOBAL:
        return align_global(s1, s2, cfg, device=device, stats=stats)
    if cfg.mode is AlignMode.LOCAL:
        return align_local(s1, s2, cfg, device=device, stats=stats)
    sc, ie, je = band_align.locate_flex_device(s1, s2, cfg, device=device)
    if je == 0 and not cfg.free_start_s2:
        # infix ending in column 0: the query against gaps, as the oracle walks
        return sc, "-" * ie, "".join(oracle.BASES[c] for c in s2[:ie])
    if ie == 0 or je == 0:
        return sc, "", ""  # the end cell is on a free boundary: an empty core
    sc0, p, q = band_align.locate_flex_device(
        s1[:je][::-1].copy(), s2[:ie][::-1].copy(), cfg, anchored=True, device=device)
    if sc0 != sc:  # pragma: no cover - a broken locate
        raise AssertionError(f"start locate {sc0} != end locate {sc}")
    i0, j0 = ie - p, je - q
    core, a1, a2 = align_global(s1[j0:je], s2[i0:ie], cfg.with_mode(AlignMode.GLOBAL),
                                device=device, stats=stats)
    if core != sc:  # pragma: no cover - a broken core
        raise AssertionError(f"core score {core} != locate score {sc}")
    return sc, a1, a2
