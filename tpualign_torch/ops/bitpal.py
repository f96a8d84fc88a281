"""Bit-parallel NW fills for the scoring family (1, 0, -g), g = 1..7, in
PyTorch and CUDA: the port of ``tpualign/ops/bitpal.py``.

The algorithm is the JAX module's (its docstring derives it): the vertical
DP deltas ``v = H(i, j) - H(i-1, j)`` lie in ``[-g, 1+g]`` and are carried as
``B = bit_length(2g+1)`` bit planes of ``enc = v + g`` (two at g = 1, three
at g = 2..3, four at g = 4..7); one column step advances a whole word of
query rows with boolean plane algebra and one carry-propagating add; the
score is ``H(nq, mt) = -g*mt + sum_i v(i, mt)`` over the final column.

The port's geometry, not the TPU's:

- 64 query rows per 64-bit word: row ``64w + b`` is bit ``b`` of word ``w``,
  and a plane is a flat ``(nw,)`` int64 tensor in word order.  No bit is
  reserved for the carry (a carry out of bit 63 is dropped; the promotion
  reaches the next word through its bottom ``h_out``).
- Five match planes, one per code 0..4, so that code 0 (the ``.bdna`` gap
  byte) matches 0 as in ``tpualign.ops.oracle``.  Rows past ``nq`` match
  nothing.
- Word ``w`` computes column ``d - w`` at step ``d``: a plain wavefront, with
  none of the TPU schedule's stagger, delay lines or lane rolls.  On the
  card (``csrc/bitpal_gfill.cu``) the words are cut into bands of
  :data:`BAND` words, one warp a band, one word a lane, the bands side by
  side over many blocks of one warp, each band's bottom ``h_out`` stream
  handed to the next band through a ring of rows in global memory with
  progress flags (:func:`pipeline_plan`).

Two kernels of one source (``csrc/bitpal_gfill.cu``), each with a plain
version that shares its contract, so they compare word for word; each
wrapper picks between kernel and plain version by the device of its
tensors:

- :func:`fill_g` (K1's port at g = 1, K2's at g >= 2): final column.
- :func:`capture_fill` (K4's port): any g, final column plus the
  horizontal deltas of chosen DP rows at every column (the rows of H that
  the k-way Hirschberg split reads).

:func:`fill_g_plain` is the plain version of both, :func:`fill_plain` it at
g = 1 (K1's contract).  A third kernel (``csrc/bitpal_batch.cu``) fills a
batch of pairs in one launch, short pairs as segments of a warp, long ones
as the bands above, a ring a pair (:func:`batch_plan`): :func:`batch_fill`
(K5's port), with the plain version :func:`batch_fill_plain`, behind
:func:`score_batch`.

``csrc/bitpal_rc.cu`` staggers each word one step behind the word above
(K3a's schedule), so that a chunk of steps resumes from an explicit
:class:`WaveState`; on the card it runs the same pipelined wavefront of
one-warp bands on that clock, every band every step of the launch, its
ring a byte a step (:func:`wave_plan`):

- :func:`fill_rc` (K3a's port): the g = 1 final column at ``rc`` = 2..4
  columns a step; plain version :func:`fill_rc_plain`.
- :func:`fill_rc_chunk` (K3b's port) and :func:`fill_g_chunk` (K4's state
  in and out, any g): one chunk of steps from a state to a state; plain
  version :func:`chunk_plain`.

:func:`score_fn` routes by ``tpualign``'s rule (:func:`route`): K3a for
short queries at g = 1, a launch a chunk past :data:`TEXT_CAP`, K1/K2
otherwise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import _build, trace
from ..config import ScoringConfig
from . import pairs as packing

WORD = 64  # query rows per int64 word
ALPHABET = 5  # match planes for codes 0..4 (.bdna: 0 = gap byte, 1..4 = ATGC)
#: largest reduced gap weight of the (1, 0, -g) family (``tpualign``'s MAX_G)
MAX_G = 7
#: the one-block kernel's geometry (``tpualign``'s), kept as the family's
#: routing rule (:func:`kernel_geometry`, :func:`wave_geometry`,
#: :func:`_orientation`, ``hirschberg``'s MAX_QUERY_ROWS): one block of up
#: to MAX_THREADS threads, each owning K consecutive words, K a power of
#: two up to MAX_K
MAX_THREADS = 1024
MAX_K = 16
#: the pipelined fills (``csrc/bitpal_gfill.cu``: K1, K2 and K4's captures;
#: ``csrc/bitpal_rc.cu``: K3a, K3b and K4's state): bands of BAND words,
#: one warp a band, one word a lane, at most BLOCKS_PER_SM bands in flight
#: on each of the H100's SMS SMs (a warp a scheduler).  Lanes of two words
#: or more and bands of several warps measured slower at every shape
#: (``tools/ab_bitpal_gfill.py``)
BAND = 32
SMS = 132
BLOCKS_PER_SM = 4
#: the batch fill (``csrc/bitpal_batch.cu``, K5's port): a pair of at most
#: SEGMENT_MAX words takes a segment of a warp, a wider one bands of BAND
SEGMENT_MAX = 16
#: the longest ring row the pipelined fills take, in text columns
#: (``bitpal_gfill``) or steps (``csrc/bitpal_rc.cu``): their progress
#: flags are int32
MAX_PIPE_TEXT = 2**31 - 1
#: most text columns a word advances per step (K3a's ``cols_per_step``)
MAX_RC = 4
#: text length past which a score runs a chunk of steps a launch.  Equal
#: to ``tpualign``'s ``TEXT_SMEM_CAP`` so that both packages take the same
#: route on the same inputs; on the card the whole text lies in device
#: memory, so the cap bounds how long one launch runs, not a memory
TEXT_CAP = 3 << 19

_JAX_WORD = 31  # rows per int32 word in the JAX package's planes


def family(cfg: ScoringConfig):
    """``(mult, g)`` if ``cfg`` is global scoring affinely equivalent to
    ``(1, 0, -g)`` for an integer ``1 <= g <= MAX_G``, else None.

    For any alignment, matches a, mismatches b and gaps G# satisfy
    ``2(a + b) + G# = m + n``, so ``S = X (m+n)/2 + (M-X) a + (G - X/2) G#``;
    when ``G - X/2 == -g (M-X)`` with ``M > X`` this is the exact affine map
    ``S = (X (m+n) + 2 (M-X) S_g) / 2`` of the score ``S_g`` under
    ``(1, 0, -g)``.  Same rule as ``tpualign.ops.bitpal.family``.
    """
    if cfg.is_local or cfg.is_affine or cfg.is_ends_free or cfg.has_matrix:
        return None
    mult = cfg.match - cfg.mismatch
    if mult <= 0:
        return None
    num = cfg.mismatch - 2 * cfg.gap  # = 2 g (M-X) when a member
    if num <= 0 or num % (2 * mult):
        return None
    g = num // (2 * mult)
    return (mult, g) if 1 <= g <= MAX_G else None


def _from_unit(cfg: ScoringConfig, total_len, unit_score):
    """Map the unit-scheme score back to ``cfg``'s scale (exact integers)."""
    mult = cfg.match - cfg.mismatch
    return (cfg.mismatch * total_len + 2 * mult * unit_score) // 2


def kernel_geometry(nw: int) -> Tuple[int, int]:
    """``(k, threads)`` of the one-block kernel for ``nw`` words: the
    fewest words per thread that fit the block.  Raises ValueError past
    ``MAX_THREADS * MAX_K`` words, the family's routing rule
    (:func:`_orientation`, :func:`score_batch`'s query bucket) for every
    kernel, the pipelined fills included."""
    k = 1
    while k <= MAX_K:
        threads = -(-nw // k)
        if threads <= MAX_THREADS:
            return k, threads
        k *= 2
    raise ValueError(
        f"query of {nw} words exceeds the one-block kernel's "
        f"{MAX_THREADS * MAX_K} words ({MAX_THREADS * MAX_K * WORD} rows)"
    )


def _orientation(m: int, n: int) -> bool:
    """True if ``s1`` (length m) becomes the query (bit axis).

    The cost model is the one-block kernel's, kept as the routing rule
    since the pipelined fill: the block runs ``mt + threads - 1`` steps and
    each thread works through its ``k`` words per step, threads in
    parallel, so the cost is ``(mt + threads - 1) * k``.  The longer
    sequence usually wins (fewer steps) until its words no longer fit one
    word per thread.  Ties go to ``s1``.  Only orientations the kernel can
    hold count; raises ValueError when neither fits.
    """

    def cost(nq, mt):
        try:
            k, threads = kernel_geometry(-(-nq // WORD))
        except ValueError:
            return None
        return (mt + threads - 1) * k

    c1, c2 = cost(m, n), cost(n, m)
    if c1 is None and c2 is None:
        raise ValueError(
            f"both sequences exceed the one-block kernel's "
            f"{MAX_THREADS * MAX_K * WORD} rows"
        )
    return c2 is None or (c1 is not None and c1 <= c2)


def n_planes(g: int) -> int:
    """Delta planes of the (1, 0, -g) family: the bit length of the largest
    enc, ``2g + 1`` (2 at g = 1, 3 at g = 2..3, 4 at g = 4..7)."""
    return (2 * g + 1).bit_length()


def _plane_step(E, b0, b1, u0, u1):
    """One g = 1 column step of every word at once (tensors of int64 words).

    ``(b0, b1)``: vertical-delta planes; ``(u0, u1)``: enc bits (0 or 1) of
    the horizontal delta entering each word's top row.  Returns the new
    planes and the planes ``(U0, U1)`` of every row's ``h_out`` enc.  Same
    algebra as the kernels' ``plane_step`` and
    ``tpualign.ops.bitpal._plane_step``; int64 adds wrap and shifts drop
    bits exactly as uint64 ones do."""
    vm1 = ~b0 & ~b1  # v = -1
    received = (vm1 + (E & vm1) + (u0 & u1)) ^ vm1
    P = E | (b0 & b1) | received  # promotion bit
    nP = ~P
    U0 = (P & ~b0) | (nP & b0 & ~b1)
    U1 = (P & ~b1) | (nP & vm1)
    U0i = (U0 << 1) | u0
    U1i = (U1 << 1) | u1
    b0n = U0i ^ P
    b1n = ~(U0i ^ U1i) ^ (U0i & P)
    return [b0n, b1n], [U0, U1]


def _add_planes(A, Bp):
    """Bit-sliced ripple add of two plane lists (mod 2^len(A)); the port of
    ``tpualign.ops.bitpal._add_planes``."""
    out = []
    carry = None
    for b, x in enumerate(A):
        y = Bp[b] if b < len(Bp) else None
        if y is None:
            s_ = x if carry is None else x ^ carry
            carry = None if carry is None else x & carry
        else:
            s_ = x ^ y if carry is None else x ^ y ^ carry
            carry = x & y if carry is None else (x & y) | (carry & (x ^ y))
        out.append(s_)
    return out


def _g_plane_step(g, E, V, u):
    """One (1, 0, -g) column step of every word at once, g >= 2: the port of
    ``tpualign.ops.bitpal._g_plane_step`` with 64-bit words (every MASK31 is
    all 64 bits).  ``V``: the B vertical-delta planes; ``u``: enc bits (0 or
    1) of each word's h_top.  The promotion bit is binary as at g = 1 and
    propagates through runs of ``enc_v = 0`` by the Myers add, whose carry
    out of bit 63 is dropped as in K1's port; both outputs are
    ``enc_out = 2g - enc_in + P``.  Returns the new ``V`` and the planes of
    every row's h_out enc."""
    vmax = 2 * g + 1
    nV = [~v for v in V]
    enc_is0 = nV[0]
    for x in nV[1:]:
        enc_is0 = enc_is0 & x
    enc_ismax = V[0] if vmax & 1 else nV[0]
    for b in range(1, len(V)):
        enc_ismax = enc_ismax & (V[b] if (vmax >> b) & 1 else nV[b])
    c_in = u[0] if vmax & 1 else ~u[0]  # h_top == vmax
    for b in range(1, len(V)):
        c_in = c_in & (u[b] if (vmax >> b) & 1 else ~u[b])
    S = E | enc_ismax
    received = (enc_is0 + (E & enc_is0) + (c_in & 1)) ^ enc_is0
    P = S | received
    # vmax as planes of all ones (-1) or zeros
    const = [-1 if (vmax >> b) & 1 else 0 for b in range(len(V))]
    U = _add_planes(_add_planes(nV, const), [P])  # 2g - enc == vmax + ~enc
    Ui = [(x << 1) | ub for x, ub in zip(U, u)]
    Vn = _add_planes(_add_planes([~x for x in Ui], const), [P])
    return Vn, U


def _check_fill_args(text: torch.Tensor, eq: torch.Tensor, nq: int) -> None:
    if nq < 1:
        raise ValueError("fill needs a query of at least one row")
    nw = -(-nq // WORD)
    if text.dtype != torch.int8 or text.dim() != 1:
        raise ValueError(f"text must be a 1-D int8 tensor, got {text.dtype} {tuple(text.shape)}")
    if eq.dtype != torch.int64 or tuple(eq.shape) != (ALPHABET, nw):
        raise ValueError(
            f"eq must be int64 of shape ({ALPHABET}, {nw}), got {eq.dtype} {tuple(eq.shape)}"
        )
    if text.device != eq.device:
        raise ValueError(f"text on {text.device} but eq on {eq.device}")
    if not (text.is_contiguous() and eq.is_contiguous()):
        raise ValueError("text and eq must be contiguous")


def _check_g(g: int) -> None:
    if not isinstance(g, int) or not 1 <= g <= MAX_G:
        raise ValueError(f"g must be an int in 1..{MAX_G}, got {g!r}")


def _check_cap_rows(cap_rows, nq: int) -> list:
    rows = [int(r) for r in cap_rows]
    if any(r < 1 or r > nq for r in rows):
        raise ValueError(f"capture rows must lie in 1..{nq}, got {rows}")
    if any(a >= b for a, b in zip(rows, rows[1:])):
        raise ValueError(f"capture rows must be strictly ascending, got {rows}")
    return rows


def fill_g_plain(text: torch.Tensor, eq: torch.Tensor, nq: int, g: int,
                 cap_rows=None):
    """Plain PyTorch version of the (1, 0, -g) fill, the contract of K2
    (final column) and K4 (final column plus captured rows):
    ``(planes, caps)``.

    ``text``: ``(mt,)`` int8 codes; ``eq``: ``(5, nw)`` int64 match planes
    (:func:`_eq_planes`).  ``planes``: the final column's vertical deltas
    ``v(i, mt)`` as :func:`n_planes` int64 planes of ``enc = v + g``.
    ``cap_rows``: strictly ascending DP rows ``r`` in ``1..nq``; ``caps`` is
    ``(len(cap_rows), mt)`` int8 with ``caps[c, j-1]`` the enc (``h + g``)
    of ``h = H(r, j) - H(r, j-1)`` for ``r = cap_rows[c]`` (``(0, mt)``
    without ``cap_rows``).  Row ``r`` is bit ``(r-1) % 64`` of the h_out
    planes of word ``(r-1) // 64``.

    :func:`_wave_plain` at one column a step over every step, from the
    column-0 boundary; :func:`chunk_plain` runs the same steps a chunk at a
    time."""
    _check_fill_args(text, eq, nq)
    _check_g(g)
    rows = _check_cap_rows([] if cap_rows is None else cap_rows, nq)
    nw, mt = eq.shape[1], text.shape[0]
    planes, _, caps, _ = _wave_plain(text, eq, g, 1, 0, total_steps(mt, nw, 1),
                                     init_state(nw, g, eq.device), rows)
    return planes, caps


class WaveState(NamedTuple):
    """The wavefront between two steps, for a fill resumed a chunk at a
    time: ``planes``, the :func:`n_planes` ``(nw,)`` int64 vertical-delta
    planes of every word at the last column it has reached; ``hand``,
    ``(nw,)`` uint8, the enc of the h_out each word produced at the last
    step (``rc`` columns of B bits, column ``c`` at bits ``c*B .. c*B+B-1``),
    which word ``w + 1`` takes at the next step."""

    planes: tuple
    hand: torch.Tensor


def init_state(nw: int, g: int, device) -> WaveState:
    """The column-0 boundary: ``v = -g`` (enc 0) in every row, no hand-off."""
    z = torch.zeros(nw, dtype=torch.int64, device=device)
    return WaveState(tuple(z.clone() for _ in range(n_planes(g))),
                     torch.zeros(nw, dtype=torch.uint8, device=device))


def total_steps(mt: int, nw: int, rc: int) -> int:
    """Steps of the wavefront: word ``w`` covers columns
    ``rc*(t-1-w) + 1 .. rc*(t-w)`` at step ``t``, so the last word's last
    window ends at step ``ceil(mt / rc) + nw - 1``."""
    return -(-mt // rc) + nw - 1


def _wave_plain(text, eq, g: int, rc: int, t0: int, t1: int, state: WaveState, rows=(),
                u_in=None, tail_word=None):
    """Steps ``t0 + 1 .. t1`` of the wavefront from ``state``:
    ``(planes, hand, caps, tail)``.

    Word ``w`` at step ``t`` advances its window ``s = t - 1 - w``, the
    columns ``rc*s + 1 .. rc*s + rc`` in turn (a word trails its
    predecessor by one step, K3a's in-lane stagger), taking each column's
    h_top from the h_out word ``w - 1`` produced for that column one step
    earlier; word 0's h_top is the top boundary (enc 0).  Columns outside
    ``1..mt`` leave the planes as they are; the h_out they produce feeds
    only columns outside ``1..mt`` too.  A vectorised step runs every word
    at once.  Captures (``rows``, one column a step from the boundary
    only) are :func:`fill_g_plain`'s.  At ``rc`` 1, ``u_in`` (``(t1 - t0,)``
    uint8) is word 0's h_top enc at each step in place of the boundary's
    0, and ``tail_word`` a word whose h_out enc at each step ``tail``
    returns (``(t1 - t0,)`` uint8; None without it)."""
    nw, mt = eq.shape[1], text.shape[0]
    dev = eq.device
    B = n_planes(g)
    # the text indices these steps read, rc*(t-1) + c - rc*w, lie in [lo, hi);
    # reversed, word w's index is at a + rc*w for a = hi - 1 - rc*(t-1) - c,
    # so each step's codes are one strided slice
    lo, hi = rc * (t0 - nw + 1), rc * t1
    idx = torch.arange(lo, hi, device=dev)
    inside = (idx >= 0) & (idx < mt)
    codes = text.long()[idx.clamp(0, max(mt - 1, 0))] if mt else idx
    # code ALPHABET selects an all-zero plane: codes outside 0..4 and the
    # columns outside 1..mt match nothing
    codes = torch.where(inside & (codes >= 0) & (codes < ALPHABET), codes, ALPHABET)
    rev, live_rev = codes.flip(0), inside.flip(0)
    eqx = torch.cat([eq, eq.new_zeros(1, nw)])
    span = rc * (nw - 1) + 1
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    V = list(state.planes)
    hand = state.hand.long()
    h = [[(hand >> (c * B + b)) & 1 for b in range(B)] for c in range(rc)]
    # capture c at step d lands in column d - cw[c] + nw - 2 of caps_pad, so
    # that every step writes in place without a mask; column j is nw + j - 2
    J = len(rows)
    cw = torch.tensor([(r - 1) // WORD for r in rows], dtype=torch.int64, device=dev)
    cb = torch.tensor([(r - 1) % WORD for r in rows], dtype=torch.int64, device=dev)
    cidx = torch.arange(J, device=dev)
    caps_pad = torch.zeros((J, mt + 2 * nw), dtype=torch.int8, device=dev)
    if u_in is not None:  # word 0's h_top bits at each step
        u_top = [(u_in.to(dev, torch.int64) >> b) & 1 for b in range(B)]
    tail = [] if tail_word is not None else None
    for t in range(t0 + 1, t1 + 1):
        hn = []
        for c in range(rc):
            a = hi - 1 - rc * (t - 1) - c
            E = eqx.gather(0, rev[a : a + span : rc].unsqueeze(0)).squeeze(0)
            live = live_rev[a : a + span : rc]
            if u_in is None:
                u = [torch.cat([zero, x[:-1]]) for x in h[c]]
            else:
                k = t - t0 - 1
                u = [torch.cat([ub[k : k + 1], x[:-1]]) for ub, x in zip(u_top, h[c])]
            Vn, U = _plane_step(E, *V, *u) if g == 1 else _g_plane_step(g, E, V, u)
            V = [torch.where(live, vn, v) for vn, v in zip(Vn, V)]
            # >> 63 is arithmetic on negative words: mask it
            hn.append([(x >> 63) & 1 for x in U])
            if tail is not None:
                tail.append(sum(hn[0][b][tail_word] << b for b in range(B)))
            if J:
                enc = sum(((U[b][cw] >> cb) & 1) << b for b in range(B))
                caps_pad[cidx, t - cw + nw - 2] = enc.to(torch.int8)
        h = hn
    packed = sum(h[c][b] << (c * B + b) for c in range(rc) for b in range(B))
    if tail is not None:
        tail = (torch.stack(tail) if tail else torch.zeros(0, dtype=torch.int64, device=dev)
                ).to(torch.uint8)
    return tuple(V), packed.to(torch.uint8), caps_pad[:, nw - 1 : nw - 1 + mt], tail


def _check_rc(rc: int) -> None:
    if not isinstance(rc, int) or not 2 <= rc <= MAX_RC:
        raise ValueError(f"rc must be an int in 2..{MAX_RC}, got {rc!r}")


def _check_chunk(eq, g: int, rc: int, t0: int, t_steps: int, state: WaveState) -> None:
    if not isinstance(rc, int) or not 1 <= rc <= MAX_RC or (rc > 1 and g != 1):
        raise ValueError(f"a chunk runs rc in 1..{MAX_RC} columns a step, more than one "
                         f"only at g = 1; got rc {rc!r} at g = {g}")
    if t0 < 0 or t_steps < 1:
        raise ValueError(f"a chunk needs t0 >= 0 and t_steps >= 1, got {t0}, {t_steps}")
    nw = eq.shape[1]
    planes, hand = state
    if len(planes) != n_planes(g) or any(
            p.dtype != torch.int64 or tuple(p.shape) != (nw,) or p.device != eq.device
            for p in planes):
        raise ValueError(f"state planes must be {n_planes(g)} int64 ({nw},) tensors on "
                         f"{eq.device}")
    if hand.dtype != torch.uint8 or tuple(hand.shape) != (nw,) or hand.device != eq.device:
        raise ValueError(f"state hand must be uint8 of shape ({nw},) on {eq.device}")


def fill_rc_plain(text: torch.Tensor, eq: torch.Tensor, nq: int, rc: int):
    """Plain PyTorch version of K3a's contract: the g = 1 final column's
    planes ``(b0, b1)`` (``enc = v + 1``), each word advancing ``rc``
    columns a step (:func:`_wave_plain`).  Equals :func:`fill_plain`'s
    planes word for word: only the order of the DP's steps differs."""
    _check_fill_args(text, eq, nq)
    _check_rc(rc)
    nw, mt = eq.shape[1], text.shape[0]
    return _wave_plain(text, eq, 1, rc, 0, total_steps(mt, nw, rc),
                       init_state(nw, 1, eq.device))[0]


def _check_stream(nw: int, t_steps: int, rc: int, u_in, tail_word, device) -> None:
    if (u_in is not None or tail_word is not None) and rc != 1:
        raise ValueError("the upstream stream and the tail run at one column a step")
    if u_in is not None and (u_in.dtype != torch.uint8 or tuple(u_in.shape) != (t_steps,)
                             or u_in.device != device or not u_in.is_contiguous()):
        raise ValueError(f"u_in must be a contiguous uint8 tensor of shape ({t_steps},) on "
                         f"{device}, got {u_in.dtype} {tuple(u_in.shape)} on {u_in.device}")
    if tail_word is not None and not (isinstance(tail_word, int) and 0 <= tail_word < nw):
        raise ValueError(f"tail_word must be an int in 0..{nw - 1}, got {tail_word!r}")


def chunk_plain(text: torch.Tensor, eq: torch.Tensor, nq: int, g: int, rc: int, t0: int,
                t_steps: int, state: WaveState, u_in: Optional[torch.Tensor] = None,
                tail_word: Optional[int] = None):
    """Plain PyTorch version of the resumable fills (K3b's contract at
    g = 1 and ``rc`` 2..4, K4's state in and out at ``rc`` 1 and any g):
    steps ``t0 + 1 .. t0 + t_steps`` of :func:`_wave_plain` from ``state``,
    returning the state after them.  ``text`` is the whole ``(mt,)`` text:
    the steps read the columns their windows cover.  From
    :func:`init_state`, chunks run in turn up to :func:`total_steps` give
    :func:`fill_g_plain`'s planes (:func:`fill_rc_plain`'s at ``rc`` > 1),
    whatever the chunk lengths; steps past the end change only the
    hand-offs.

    K4's sharded contract at ``rc`` 1 (:func:`fill_g_stream`): ``u_in``
    ``(t_steps,)`` uint8 is word 0's h_top enc at each step in place of
    the boundary's 0, and with ``tail_word`` (a word) the result is
    ``(state, tail)``, ``tail`` ``(t_steps,)`` uint8 that word's h_out enc
    at each step."""
    _check_fill_args(text, eq, nq)
    _check_g(g)
    _check_chunk(eq, g, rc, t0, t_steps, state)
    _check_stream(eq.shape[1], t_steps, rc, u_in, tail_word, eq.device)
    planes, hand, _, tail = _wave_plain(text, eq, g, rc, t0, t0 + t_steps, state,
                                        u_in=u_in, tail_word=tail_word)
    if tail_word is None:
        return WaveState(planes, hand)
    return WaveState(planes, hand), tail


def fill_plain(text: torch.Tensor, eq: torch.Tensor, nq: int):
    """Plain PyTorch version of the fill (the K1 contract): the final
    column's vertical-delta planes ``(b0, b1)``, ``enc = v + 1``;
    :func:`fill_g_plain` at g = 1."""
    return fill_g_plain(text, eq, nq, 1)[0]


class PipePlan(NamedTuple):
    """One launch of a pipelined fill: ``bands`` bands of :data:`BAND`
    words over ``blocks`` blocks of one warp, a ring of ``depth`` rows (0
    with one band) of a byte a text column (``bitpal_gfill``) or a step
    (``csrc/bitpal_rc.cu``, :func:`wave_plan`)."""

    blocks: int
    bands: int
    depth: int


def pipeline_plan(nw: int, mt: int, blocks: Optional[int] = None,
                  budget: Optional[int] = None) -> PipePlan:
    """The launch of the pipelined fill of ``nw`` words and ``mt`` columns
    (:func:`wave_plan` passes the steps of a staggered fill as ``mt``):
    ``ceil(nw / BAND)`` bands over ``blocks`` blocks, default ``min(bands,
    SMS * BLOCKS_PER_SM)``.  The ring holds ``min(bands, blocks + 1)`` rows
    of ``mt`` bytes (a block reads the row above while the other blocks'
    bands are in flight), fewer if they pass ``budget`` bytes (default
    ``band.RING_BUDGET``; the CUDA wrappers pass ``band.ring_budget()``),
    never fewer than 2 with two bands or more.  ValueError for a shape or
    a block count the kernel refuses; ``torch.OutOfMemoryError`` when 2
    rows do not fit the budget, which no route falls back on."""
    if nw < 1:
        raise ValueError(f"the fill needs a word of query rows, got {nw} words")
    if not 0 <= mt <= MAX_PIPE_TEXT:
        raise ValueError(f"the pipelined fill takes texts of 0..{MAX_PIPE_TEXT} columns, "
                         f"got {mt}")
    bands = -(-nw // BAND)
    blocks = min(bands, SMS * BLOCKS_PER_SM) if blocks is None else int(blocks)
    if blocks < 1:
        raise ValueError(f"blocks must be at least 1, got {blocks}")
    if bands == 1:
        return PipePlan(blocks, bands, 0)
    if budget is None:
        from .band import RING_BUDGET as budget  # band imports this module
    depth = min(bands, blocks + 1, int(budget) // max(mt, 1))
    if depth < 2:
        raise torch.OutOfMemoryError(
            f"a ring of 2 rows of {mt} columns takes {2 * mt} bytes, past the budget of "
            f"{budget} bytes of device memory")
    return PipePlan(blocks, bands, depth)


def row_owner(row: int) -> Tuple[int, int]:
    """``(band, lane)``: the band and the lane of its warp that own DP row
    ``row`` (1-based) in the pipelined fill; the lane stores the row's
    captures."""
    return divmod((row - 1) // WORD, BAND)


def band_edge_rows(nq: int) -> list:
    """Rows where a capture is most easily lost in the pipelined fill: the
    first and last rows of the first two bands' first and last words, row
    1 and row ``nq``."""
    rows = {1, nq}
    for edge in (BAND * WORD, 2 * BAND * WORD):  # the first two bands' last rows
        rows |= {edge - WORD, edge - WORD + 1, edge - 1, edge, edge + 1, edge + WORD}
    return sorted(r for r in rows if 1 <= r <= nq)


def _gfill_launch(text, eq, nq: int, g: int, rows, blocks):
    """Launch ``bitpal_gfill`` (``rows`` None) or ``bitpal_capture_fill``
    on the current stream over :func:`pipeline_plan`'s plan (the ring
    within ``band.ring_budget``: ``torch.OutOfMemoryError`` past it),
    counted in ``launch.bitpal_gfill`` or ``launch.bitpal_capture_fill``;
    returns ``(planes, caps)``."""
    if text.device.type != "cuda":
        raise ValueError(f"the fills run on cpu or cuda tensors, got {text.device}")
    from .band import ringed  # band imports this module
    nw, mt = eq.shape[1], text.shape[0]
    dev = text.device
    lib = _build.load()
    J = 0 if rows is None else len(rows)

    def scratch(plan):
        with trace.span("alloc"):
            planes = torch.empty((n_planes(g), nw), dtype=torch.int64, device=dev)
            caps = torch.empty((J, mt), dtype=torch.int8, device=dev)
            ring = (torch.empty((plan.depth, mt), dtype=torch.uint8, device=dev)
                    if plan.depth else None)
            sync = torch.zeros(plan.bands + 1, dtype=torch.int32, device=dev)
        trace.count_bytes("alloc_bytes", planes, caps, ring, sync)
        return planes, caps, ring, sync

    plan, (planes, caps, ring, sync) = ringed(
        dev, lambda budget: pipeline_plan(nw, mt, blocks, budget), scratch)
    head = (text.data_ptr(), eq.data_ptr(), mt, nw, g, plan.blocks,
            None if ring is None else ring.data_ptr(), plan.depth, sync.data_ptr())
    name = "bitpal_gfill" if rows is None else "bitpal_capture_fill"
    if rows is not None:
        with trace.span("to_device"):
            rows_t = torch.tensor(rows, dtype=torch.int32).to(dev)
    with trace.span("launch." + name), torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if rows is None:
            err = lib.bitpal_gfill(*head, planes.data_ptr(), stream)
        else:
            err = lib.bitpal_capture_fill(*head, rows_t.data_ptr(), J, caps.data_ptr(),
                                          planes.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    trace.count("launch." + name)
    return planes.unbind(0), caps


def fill_g(text: torch.Tensor, eq: torch.Tensor, nq: int, g: int,
           blocks: Optional[int] = None):
    """The (1, 0, -g) fill's final column (K1's contract at g = 1, K2's at
    g >= 2) on the device of its tensors: the CUDA kernel ``bitpal_gfill``
    (``csrc/bitpal_gfill.cu``)
    for CUDA tensors, :func:`fill_g_plain` for CPU tensors.  Returns the
    :func:`n_planes` planes of :func:`fill_g_plain`.

    ``blocks``: the launch's blocks (:func:`pipeline_plan`'s default where
    None); it never changes the result.  On CUDA it allocates the outputs,
    then the ring and the flags, launches on the current stream without
    synchronising, and counts the launch in ``launch.bitpal_gfill``.  A launch
    the device refuses raises, and so does a ring that does not fit the
    device's memory; nothing falls back to the plain version."""
    _check_fill_args(text, eq, nq)
    _check_g(g)
    if text.device.type == "cpu":
        return fill_g_plain(text, eq, nq, g)[0]
    planes, _ = _gfill_launch(text, eq, nq, g, None, blocks)
    return planes


def capture_fill(text: torch.Tensor, eq: torch.Tensor, nq: int, g: int,
                 cap_rows, blocks: Optional[int] = None):
    """The (1, 0, -g) fill's final column plus the horizontal deltas of the
    DP rows ``cap_rows`` at every column (K4's contract), on the device of
    its tensors: the CUDA kernel ``bitpal_capture_fill``
    (``csrc/bitpal_gfill.cu``) for CUDA tensors, :func:`fill_g_plain` for
    CPU tensors.  Returns ``(planes, caps)`` as :func:`fill_g_plain` does.

    ``blocks`` as in :func:`fill_g`.  On CUDA it launches as
    :func:`fill_g` does and counts the launch in
    ``launch.bitpal_capture_fill``."""
    _check_fill_args(text, eq, nq)
    _check_g(g)
    rows = _check_cap_rows(cap_rows, nq)
    if text.device.type == "cpu":
        return fill_g_plain(text, eq, nq, g, rows)
    return _gfill_launch(text, eq, nq, g, rows, blocks)


def wave_geometry(nw: int) -> Tuple[int, int]:
    """``(k, threads)`` of ``tpualign``'s one-block staggered kernels for
    ``nw`` words: :func:`kernel_geometry`'s words per thread, the threads
    rounded up to whole warps.  Kept as the family's routing rule only
    (:func:`score_fn` refuses a query past it on the rc and chunked
    routes); ``csrc/bitpal_rc.cu`` runs :func:`wave_plan`'s pipeline."""
    k, threads = kernel_geometry(nw)
    return k, -(-threads // 32) * 32


def wave_plan(nw: int, steps: int, blocks: Optional[int] = None,
              budget: Optional[int] = None) -> PipePlan:
    """The launch of a staggered fill (``csrc/bitpal_rc.cu``) of ``nw``
    words over ``steps`` steps: :func:`pipeline_plan` with ring rows of a
    byte a step, ``steps`` of them (a chunk's ``t_steps``, K3a's
    :func:`total_steps`).  ValueError past :data:`MAX_PIPE_TEXT` steps (the
    progress flags are int32), ``torch.OutOfMemoryError`` when 2 rows pass
    the budget."""
    if not 0 <= steps <= MAX_PIPE_TEXT:
        raise ValueError(f"a staggered fill runs 0..{MAX_PIPE_TEXT} steps a launch, got {steps}")
    return pipeline_plan(nw, steps, blocks, budget)


def wave_scratch(nw: int, steps: int, device, blocks: Optional[int] = None):
    """``(plan, ring, sync)`` of one launch of a staggered fill:
    :func:`wave_plan`'s plan within ``band.ring_budget`` of ``device``, its
    ring (uninitialised: every byte is written before it is read) and its
    zeroed flags."""
    from .band import ringed  # band imports this module
    dev = torch.device(device)

    def scratch(plan):
        with trace.span("alloc"):
            ring = (torch.empty((plan.depth, steps), dtype=torch.uint8, device=dev)
                    if plan.depth else None)
            sync = torch.zeros(plan.bands + 1, dtype=torch.int32, device=dev)
        trace.count_bytes("alloc_bytes", ring, sync)
        return ring, sync

    plan, (ring, sync) = ringed(dev, lambda budget: wave_plan(nw, steps, blocks, budget),
                                scratch)
    return plan, ring, sync


def _check_blocks(blocks) -> None:
    if blocks is not None and (not isinstance(blocks, int) or blocks < 1):
        raise ValueError(f"blocks must be None or an int of at least 1, got {blocks!r}")


def _wave_launch(name: str, text, eq, g: int, rc: int, blocks, t0: int = 0,
                 t_steps: Optional[int] = None, state: Optional[WaveState] = None,
                 stream_args=()):
    """Launch the entry ``name`` of ``csrc/bitpal_rc.cu`` on the current
    stream over :func:`wave_scratch`'s plan, ring and flags: returns
    ``(out, plan)``, ``out`` the planes for ``bitpal_rc_fill`` (``state``
    None), the state after the chunk for a chunk entry.  The entries take
    ``rc``, or ``g`` at one column a step (``bitpal_gfill_chunk``);
    ``stream_args`` are ``bitpal_gfill_stream``'s ``(u_in, tail,
    tail_word)``.  The launch is counted in ``launch.`` + ``name``."""
    if text.device.type != "cuda":
        raise ValueError(f"the fills run on cpu or cuda tensors, got {text.device}")
    nw, mt = eq.shape[1], text.shape[0]
    dev = text.device
    steps = total_steps(mt, nw, rc) if state is None else t_steps
    lib = _build.load()
    plan, ring, sync = wave_scratch(nw, steps, dev, blocks)
    with trace.span("alloc"):
        planes = torch.empty((n_planes(g), nw), dtype=torch.int64, device=dev)
        hand = None if state is None else torch.empty(nw, dtype=torch.uint8, device=dev)
    trace.count_bytes("alloc_bytes", planes, hand)
    entry = getattr(lib, name)
    head = (text.data_ptr(), eq.data_ptr(), mt, nw, rc if rc > 1 else g, plan.blocks,
            None if ring is None else ring.data_ptr(), plan.depth, sync.data_ptr())
    with trace.span("launch." + name), torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if state is None:
            err = entry(*head, planes.data_ptr(), stream)
        else:
            v_in = torch.stack(state.planes)
            err = entry(*head, t0, t_steps, v_in.data_ptr(), state.hand.data_ptr(),
                        planes.data_ptr(), hand.data_ptr(), *stream_args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    trace.count("launch." + name)
    return (planes.unbind(0) if state is None else WaveState(planes.unbind(0), hand)), plan


def fill_rc(text: torch.Tensor, eq: torch.Tensor, nq: int, rc: int,
            blocks: Optional[int] = None):
    """K3a's contract, the g = 1 final column at ``rc`` columns a step, on
    the device of its tensors: the CUDA kernel ``bitpal_rc_fill``
    (``csrc/bitpal_rc.cu``) for CUDA tensors, :func:`fill_rc_plain` for CPU
    tensors.  Returns the planes ``(b0, b1)``.

    ``blocks``: the launch's blocks (:func:`wave_plan`'s default where
    None); it never changes the result.  On CUDA it allocates the output,
    the ring and the flags, launches on the current stream without
    synchronising, counts the launch in ``launch.bitpal_rc_fill`` and keeps its
    plan in ``fill_rc.last_plan``.  A launch the device refuses raises,
    and so does a ring that does not fit the device's memory; nothing falls
    back to another kernel or the plain version."""
    _check_fill_args(text, eq, nq)
    _check_rc(rc)
    _check_blocks(blocks)
    if text.device.type == "cpu":
        return fill_rc_plain(text, eq, nq, rc)
    planes, fill_rc.last_plan = _wave_launch("bitpal_rc_fill", text, eq, 1, rc, blocks)
    return planes


fill_rc.last_plan = None


def fill_rc_chunk(text: torch.Tensor, eq: torch.Tensor, nq: int, rc: int, t0: int,
                  t_steps: int, state: WaveState, blocks: Optional[int] = None) -> WaveState:
    """K3b's contract, one chunk of K3a's fill resumed from ``state``
    (:func:`chunk_plain` at g = 1), on the device of its tensors: the CUDA
    kernel ``bitpal_rc_chunk`` (``csrc/bitpal_rc.cu``) for CUDA tensors,
    :func:`chunk_plain` for CPU tensors.  Returns the state after steps
    ``t0 + 1 .. t0 + t_steps``; on CUDA as :func:`fill_rc`, counted in
    ``launch.bitpal_rc_chunk``, its plan in ``fill_rc_chunk.last_plan``."""
    _check_fill_args(text, eq, nq)
    _check_rc(rc)
    _check_chunk(eq, 1, rc, t0, t_steps, state)
    _check_blocks(blocks)
    if text.device.type == "cpu":
        return chunk_plain(text, eq, nq, 1, rc, t0, t_steps, state)
    out, fill_rc_chunk.last_plan = _wave_launch("bitpal_rc_chunk", text, eq, 1, rc, blocks,
                                                t0, t_steps, state)
    return out


fill_rc_chunk.last_plan = None


def fill_g_chunk(text: torch.Tensor, eq: torch.Tensor, nq: int, g: int, t0: int,
                 t_steps: int, state: WaveState, blocks: Optional[int] = None) -> WaveState:
    """K4's state in and out: one chunk of the (1, 0, -g) fill at one
    column a step, resumed from ``state`` (:func:`chunk_plain` at rc 1),
    word 0's h_top the top boundary.  On the device of its tensors: the
    CUDA kernel ``bitpal_gfill_chunk`` (``csrc/bitpal_rc.cu``) for CUDA
    tensors, :func:`chunk_plain` for CPU tensors; on CUDA as
    :func:`fill_rc_chunk`, counted in ``launch.bitpal_gfill_chunk``, its plan in
    ``fill_g_chunk.last_plan``."""
    _check_fill_args(text, eq, nq)
    _check_g(g)
    _check_chunk(eq, g, 1, t0, t_steps, state)
    _check_blocks(blocks)
    if text.device.type == "cpu":
        return chunk_plain(text, eq, nq, g, 1, t0, t_steps, state)
    out, fill_g_chunk.last_plan = _wave_launch("bitpal_gfill_chunk", text, eq, g, 1, blocks,
                                               t0, t_steps, state)
    return out


fill_g_chunk.last_plan = None


def fill_g_stream(text: torch.Tensor, eq: torch.Tensor, nq: int, g: int, t0: int,
                  t_steps: int, state: WaveState, u_in: Optional[torch.Tensor],
                  tail_word: int, blocks: Optional[int] = None):
    """K4's sharded contract: :func:`fill_g_chunk` with word 0's h_top at
    each step from ``u_in`` (``(t_steps,)`` uint8, the upstream shard's
    tail; None: the boundary's 0) and the h_out of word ``tail_word`` at
    each step out, as ``(state, tail)`` (:func:`chunk_plain`'s).  On the
    device of its tensors: the CUDA kernel ``bitpal_gfill_stream``
    (``csrc/bitpal_rc.cu``) for CUDA tensors, :func:`chunk_plain` for CPU
    tensors; on CUDA as :func:`fill_g_chunk`, counted in
    ``launch.bitpal_gfill_stream``, its plan in ``fill_g_stream.last_plan``."""
    _check_fill_args(text, eq, nq)
    _check_g(g)
    _check_chunk(eq, g, 1, t0, t_steps, state)
    _check_stream(eq.shape[1], t_steps, 1, u_in, tail_word, eq.device)
    _check_blocks(blocks)
    if text.device.type == "cpu":
        return chunk_plain(text, eq, nq, g, 1, t0, t_steps, state, u_in, tail_word)
    with trace.span("alloc"):
        tail = torch.empty(t_steps, dtype=torch.uint8, device=text.device)
    trace.count_bytes("alloc_bytes", tail)
    stream_args = (None if u_in is None else u_in.data_ptr(), tail.data_ptr(), tail_word)
    out, fill_g_stream.last_plan = _wave_launch("bitpal_gfill_stream", text, eq, g, 1, blocks,
                                                t0, t_steps, state, stream_args)
    return out, tail


fill_g_stream.last_plan = None


def chunk_steps(rc: int, text_cap: Optional[int] = None) -> int:
    """Steps a chunk of the chunked routes: ``tpualign``'s ``t_steps``
    (``_score_chunked_rc_fn``, ``_score_chunked_fn``), half the cap's
    columns, without its rounding to the TPU kernel's unroll."""
    text_cap = TEXT_CAP if text_cap is None else text_cap
    return max(1, min(text_cap, TEXT_CAP // 2) // rc)


def fill_chunked(text: torch.Tensor, eq: torch.Tensor, nq: int, g: int, rc: int,
                 t_steps: int):
    """The final column's planes through chunks of ``t_steps`` steps in
    turn, from the column-0 boundary: :func:`fill_rc_chunk` at ``rc`` > 1,
    :func:`fill_g_chunk` at ``rc`` 1.  The last chunk stops at the last
    step (``tpualign``'s runs a whole chunk, the shape of its scan).  On
    the card the state stays there between chunks and nothing
    synchronises."""
    nw, mt = eq.shape[1], text.shape[0]
    total = total_steps(mt, nw, rc)
    state = init_state(nw, g, eq.device)
    for t0 in range(0, total, t_steps):
        steps = min(t_steps, total - t0)
        if rc > 1:
            state = fill_rc_chunk(text, eq, nq, rc, t0, steps, state)
        else:
            state = fill_g_chunk(text, eq, nq, g, t0, steps, state)
    return state.planes


def _eq_planes(query: torch.Tensor, nq: int) -> torch.Tensor:
    """``(5, nw)`` int64: bit ``b`` of word ``w`` of plane ``c`` set iff
    ``query[64w + b] == c``; rows past ``nq`` are set in no plane (the span
    ``planes``)."""
    with trace.span("planes"):
        nw = -(-nq // WORD)
        q = torch.full((nw * WORD,), -1, dtype=torch.int64, device=query.device)
        q[:nq] = query
        return _eq_planes_batch(q.view(1, -1))[0]


def _eq_planes_batch(queries: torch.Tensor) -> torch.Tensor:
    """``(P, 5, nw)`` int64: the match planes of each row of ``queries``
    ``(P, nw * 64)``, rows past a pair's query padded with a code outside
    0..4 (set in no plane)."""
    P, rows = queries.shape
    dev = queries.device
    q = queries.long().view(P, 1, rows // WORD, WORD)
    hits = q == torch.arange(ALPHABET, device=dev).view(1, -1, 1, 1)
    # distinct powers of two never carry, so the sum is the OR (bit 63 wraps
    # to the sign bit as intended)
    weights = torch.ones(WORD, dtype=torch.int64, device=dev) << torch.arange(WORD, device=dev)
    return (hits.long() * weights).sum(-1)


def row_deltas(planes, nq: int, g: int = 1) -> torch.Tensor:
    """``(nq,)`` int64: the final column's ``v(i, mt)`` for each query row,
    ``enc - g`` read back from the port's 64-row planes (a sequence of
    :func:`n_planes` ``(nw,)`` int64 planes)."""
    shifts = torch.arange(WORD, device=planes[0].device)
    enc = sum(((p.unsqueeze(1) >> shifts) & 1) << b for b, p in enumerate(planes))
    return enc.reshape(-1)[:nq] - g


def planes_from_jax(planes, nq: int):
    """The port's ``(nw,)`` int64 planes from the JAX kernels' (K1, K2 or
    K4): a sequence of ``tpualign``'s ``(rows, 128)`` int32 planes (numpy),
    31 rows per word, word ``w`` at ``(w % rows, w // rows)``; bit 31 of
    every word and the rows past ``nq`` in the last word are ignored."""
    nw = -(-nq // WORD)

    def convert(plane):
        words = np.asarray(plane).T.reshape(-1).astype(np.int64)  # word order
        nw31 = -(-nq // _JAX_WORD)
        bits = ((words[:nw31, None] >> np.arange(_JAX_WORD)) & 1).reshape(-1)
        rows = np.zeros(nw * WORD, np.uint64)
        rows[:nq] = bits[:nq]
        weights = np.uint64(1) << np.arange(WORD, dtype=np.uint64)
        packed = (rows.reshape(nw, WORD) * weights).sum(axis=1, dtype=np.uint64)
        return torch.from_numpy(packed.view(np.int64))

    return tuple(convert(p) for p in planes)


def _reduce_score(planes, nq: int, mt: int, g: int = 1) -> torch.Tensor:
    """Reduced-scheme score ``H(nq, mt) = -g*mt + sum_i v(i, mt)``, i.e.
    ``sum enc - g*(mt + nq)``."""
    return row_deltas(planes, nq, g).sum() - g * mt


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' for the plain PyTorch path"
        )
    return dev


_NOT_FAMILY = (
    "bitpal engine requires global scoring affinely reducible to "
    "(1, 0, -g) for integer 1 <= g <= 7"
)


_NOT_UNIT = "bitpal engine requires unit-equivalent global scoring"

# tpualign's TPU layout, for its routing rule: 31 rows per int32 word, words
# placed column-major in (rows, 128) tiles rounded to (8, 128), the step
# count rounded to its unroll of 32
_TPU_LANES, _TPU_GRAIN, _TPU_UNROLL = 128, 1024, 32


def _tpu_layout(nq: int, mt: int) -> Tuple[int, int, int]:
    """``(nw, rows, total)`` of ``tpualign.ops.bitpal._layout``."""
    nw = -(-nq // _JAX_WORD)
    rows = -(-nw // _TPU_GRAIN) * _TPU_GRAIN // _TPU_LANES
    total = -(-(mt + 2 * (nw - 1)) // _TPU_UNROLL) * _TPU_UNROLL
    return nw, rows, total


def _tpu_orientation(m: int, n: int) -> bool:
    """``tpualign.ops.bitpal._orientation``: True if ``s1`` becomes the
    query, by the TPU's padded work (steps x slots); ties go to ``s1``."""

    def cost(nq, mt):
        _, rows, total = _tpu_layout(nq, mt)
        return total * rows * _TPU_LANES

    return cost(m, n) <= cost(n, m)


def route(m: int, n: int, cfg: ScoringConfig = ScoringConfig(),
          cols_per_step: Optional[int] = None, text_cap: Optional[int] = None):
    """``(kind, rc, s1_is_query)``: how :func:`score_fn` scores lengths
    ``m, n >= 1`` under a family ``cfg``, by ``tpualign``'s rule
    (``_score_fn_build``) kept here in its own terms:

    - the query is the side ``tpualign``'s orientation picks, and ``mt``
      the other length; ``rc`` is ``cols_per_step``, or by default 4 at
      g = 1 when the query fills at most 16 rows of 128 31-bit words (up
      to 63,488 bases) and 1 otherwise;
    - ``"fill_g"`` (K1 at g = 1, K2 at g >= 2): one launch at one column a
      step, when ``mt <= text_cap`` and ``rc`` is 1 or g >= 2.  This route
      alone keeps the port's own :func:`_orientation`;
    - ``"rc"`` (K3a): one launch at ``rc`` 2..4 columns a step, g = 1,
      ``mt <= text_cap``;
    - ``"rc_chunk"`` (K3b): ``mt > text_cap``, ``rc`` > 1, a launch a
      chunk;
    - ``"g_chunk"`` (K4 with its state): ``mt > text_cap``, ``rc`` 1, any
      g, a launch a chunk.

    ``text_cap`` None is :data:`TEXT_CAP`.  Raises ValueError as
    ``tpualign`` does for a config outside the family
    or a ``cols_per_step`` it refuses, and where the ``"fill_g"`` route's
    orientation finds neither side fits one block."""
    fam = family(cfg)
    if fam is None:
        raise ValueError(_NOT_UNIT)
    g = fam[1]
    text_cap = TEXT_CAP if text_cap is None else text_cap
    s1_is_query = _tpu_orientation(m, n)
    nq, mt = (m, n) if s1_is_query else (n, m)
    rc = cols_per_step
    if rc is None:
        rc = 4 if g == 1 and _tpu_layout(nq, mt)[1] <= 16 else 1
    elif not 1 <= rc <= MAX_RC:
        raise ValueError("cols_per_step must be in 1..4")
    elif rc > 1 and g > 1:
        raise ValueError("cols_per_step > 1 requires the g=1 family")
    if mt > text_cap:
        return ("rc_chunk" if rc > 1 else "g_chunk"), rc, s1_is_query
    if rc > 1:
        return "rc", rc, s1_is_query
    return "fill_g", 1, _orientation(m, n)


def score_fn(m: int, n: int, cfg: ScoringConfig = ScoringConfig(), *, device,
             cols_per_step: Optional[int] = None, text_cap: Optional[int] = None):
    """``(s1, s2) -> score`` for fixed lengths ``m = len(s1)``,
    ``n = len(s2)``: takes int8 code tensors on ``device`` and returns the
    score as a 0-d int64 tensor there, without synchronising.

    Refuses what ``tpualign.ops.bitpal.score_fn`` refuses, with its
    messages (ValueError for a config outside the family, past the int32
    headroom rule, or a ``cols_per_step`` outside 1..4 or above 1 at
    g >= 2), and a query past one block (:func:`kernel_geometry`).  Takes
    :func:`route`'s route: :func:`fill_g`, :func:`fill_rc`, or
    :func:`fill_chunked` over :func:`fill_rc_chunk` or :func:`fill_g_chunk`
    in chunks of :func:`chunk_steps` steps."""
    fam = family(cfg)
    if fam is None:
        raise ValueError(_NOT_UNIT)
    mult, g = fam
    # the JAX package maps scores in int32 on device; the port computes in
    # int64 but refuses the same inputs
    if (abs(cfg.mismatch) + 2 * mult * g) * (m + n) >= 2**31:
        raise ValueError("scoring magnitudes too large for int32 headroom")
    dev = _device(device)
    if m == 0 or n == 0:
        return lambda s1, s2: torch.tensor(cfg.gap * (m + n), device=dev)
    kind, rc, s1_is_query = route(m, n, cfg, cols_per_step, text_cap)
    nq, mt = (m, n) if s1_is_query else (n, m)
    if kind != "fill_g":
        wave_geometry(-(-nq // WORD))  # refuses a query past one block
    t_steps = chunk_steps(rc, text_cap)

    def fn(s1: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
        if (s1.numel(), s2.numel()) != (m, n):
            raise ValueError(f"score_fn built for lengths ({m}, {n}), got "
                             f"({s1.numel()}, {s2.numel()})")
        query, text = (s1, s2) if s1_is_query else (s2, s1)
        eq = _eq_planes(query, nq)
        if kind == "fill_g":
            planes = fill_g(text, eq, nq, g)
        elif kind == "rc":
            planes = fill_rc(text, eq, nq, rc)
        else:
            planes = fill_chunked(text, eq, nq, g, rc, t_steps)
        with trace.span("reduce"):  # on the card, its enqueue
            return _from_unit(cfg, mt + nq, _reduce_score(planes, nq, mt, g))

    return fn


def _codes(seq) -> np.ndarray:
    a = np.asarray(seq)
    if a.ndim != 1:
        raise ValueError(f"sequence must be 1-D, got shape {a.shape}")
    if a.size and (a.min() < 0 or a.max() >= ALPHABET):
        raise ValueError("bitpal scores .bdna codes 0..4")
    return np.ascontiguousarray(a, dtype=np.int8)


def score(s1, s2, cfg: ScoringConfig = ScoringConfig(), *, device,
          cols_per_step: Optional[int] = None, text_cap: Optional[int] = None) -> int:
    """NW score of two code sequences on ``device`` (``"cuda"`` runs the
    kernels, ``"cpu"`` their plain versions) by :func:`score_fn`'s route;
    the counterpart of ``tpualign.ops.bitpal.score``."""
    if family(cfg) is None:
        raise ValueError(_NOT_FAMILY)
    with trace.span("check"):
        s1, s2 = _codes(s1), _codes(s2)
    dev = _device(device)
    fn = score_fn(s1.size, s2.size, cfg, device=dev, cols_per_step=cols_per_step,
                  text_cap=text_cap)
    with trace.span("to_device"):
        d1, d2 = torch.from_numpy(s1).to(dev), torch.from_numpy(s2).to(dev)
    res = fn(d1, d2)
    with trace.span("read_back"):
        return int(res)


def _check_batch_args(texts: torch.Tensor, tlen: torch.Tensor, eq: torch.Tensor,
                      nq: int) -> None:
    if texts.dtype != torch.int8 or texts.dim() != 2 or texts.shape[1] < 1:
        raise ValueError(f"texts must be (P, m_cap) int8, got {texts.dtype} "
                         f"{tuple(texts.shape)}")
    P = texts.shape[0]
    nw = -(-nq // WORD) if nq >= 1 else 0
    if P < 1 or nw < 1:
        raise ValueError(f"the batch fill needs a pair and a query row, got {P} pairs, nq {nq}")
    if tlen.dtype != torch.int64 or tuple(tlen.shape) != (P,):
        raise ValueError(f"tlen must be int64 of shape ({P},), got {tlen.dtype} "
                         f"{tuple(tlen.shape)}")
    if eq.dtype != torch.int64 or tuple(eq.shape) != (P, ALPHABET, nw):
        raise ValueError(f"eq must be int64 of shape ({P}, {ALPHABET}, {nw}), got "
                         f"{eq.dtype} {tuple(eq.shape)}")
    if not (texts.device == tlen.device == eq.device):
        raise ValueError(f"texts on {texts.device}, tlen on {tlen.device}, eq on {eq.device}")
    if not (texts.is_contiguous() and tlen.is_contiguous() and eq.is_contiguous()):
        raise ValueError("texts, tlen and eq must be contiguous")


def batch_fill_plain(texts: torch.Tensor, tlen: torch.Tensor, eq: torch.Tensor, nq: int,
                     g: int) -> torch.Tensor:
    """Plain PyTorch version of the batch fill (K5's contract):
    :func:`fill_g_plain`'s wavefront with a leading pair axis.

    ``texts``: ``(P, m_cap)`` int8 codes, pair ``p``'s text in
    ``texts[p, :tlen[p]]``; ``tlen``: ``(P,)`` int64 text lengths in
    ``1..m_cap``; ``eq``: ``(P, 5, nw)`` int64 match planes
    (:func:`_eq_planes` of each pair's query, ``nw`` words of ``nq`` rows,
    rows past a pair's query set in no plane).  Returns ``(P, B, nw)``
    int64: pair ``p``'s final column ``v(i, tlen[p])`` as the
    :func:`n_planes` planes of ``enc = v + g`` over every word.

    Step ``d`` runs word ``w`` of every pair at column ``d - w``; a pair's
    words keep their state outside its columns ``1..tlen[p]``, so each pair
    freezes past its own text."""
    _check_batch_args(texts, tlen, eq, nq)
    _check_g(g)
    P, m_cap = texts.shape
    nw = eq.shape[2]
    dev = eq.device
    codes = texts.long()
    cols = torch.arange(m_cap, device=dev)
    live_cols = cols < tlen.view(-1, 1)
    # code ALPHABET selects an all-zero plane: codes outside 0..4 and the
    # padding match nothing
    codes = torch.where(live_cols & (codes >= 0) & (codes < ALPHABET), codes, ALPHABET)
    eqx = torch.cat([eq, eq.new_zeros(P, 1, nw)], dim=1)
    pad = torch.full((P, nw), ALPHABET, dtype=torch.int64, device=dev)
    off = torch.zeros((P, nw), dtype=torch.bool, device=dev)
    # reversed padded texts: word w at step d reads rev[:, m_cap + nw - d + w]
    rev = torch.cat([pad, codes, pad], dim=1).flip(1)
    live_rev = torch.cat([off, live_cols, off], dim=1).flip(1)
    zero = torch.zeros((P, 1), dtype=torch.int64, device=dev)
    B = n_planes(g)
    V = [torch.zeros((P, nw), dtype=torch.int64, device=dev) for _ in range(B)]
    h = [torch.zeros((P, nw), dtype=torch.int64, device=dev) for _ in range(B)]
    for d in range(1, m_cap + nw):
        lo = m_cap + nw - d
        E = eqx.gather(1, rev[:, lo : lo + nw].unsqueeze(1)).squeeze(1)
        live = live_rev[:, lo : lo + nw]
        # word 0's h_top is the top boundary h = -g: enc 0
        u = [torch.cat([zero, x[:, :-1]], dim=1) for x in h]
        Vn, U = _plane_step(E, *V, *u) if g == 1 else _g_plane_step(g, E, V, u)
        V = [torch.where(live, vn, v) for vn, v in zip(Vn, V)]
        h = [(x >> 63) & 1 for x in U]
    return torch.stack(V, dim=1)


class BatchPlan(NamedTuple):
    """One launch of the batch fill (``csrc/bitpal_batch.cu``) over
    ``blocks`` blocks of one warp: each pair takes ``width`` lanes, a
    segment of a warp (1..:data:`SEGMENT_MAX`) or :data:`BAND` (``bands``
    bands of one warp), and with two bands or more a ring of ``depth`` rows
    (0 otherwise)."""

    width: int
    bands: int
    blocks: int
    depth: int


def batch_plan(P: int, nw: int, m_cap: int, blocks: Optional[int] = None,
               budget: Optional[int] = None) -> BatchPlan:
    """The launch of the batch fill of ``P`` pairs of ``nw`` words and texts
    of up to ``m_cap`` columns.  At most :data:`SEGMENT_MAX` words a pair
    takes a segment of the next power of two lanes, ``32 / width`` pairs a
    warp, and ``blocks`` defaults to a warp a block.  Past it a pair takes
    ``ceil(nw / BAND)`` bands, the blocks default to ``min(P * bands, SMS *
    BLOCKS_PER_SM)``, and with two bands or more each pair has a ring of
    ``min(bands, blocks + 1)`` rows of ``m_cap`` bytes, fewer if the ``P``
    rings pass ``budget`` bytes (default ``band.RING_BUDGET``; the CUDA
    wrapper passes ``band.ring_budget()``), never fewer than 2.
    ValueError for a batch or a block count the kernel refuses;
    ``torch.OutOfMemoryError`` when rings of 2 rows do not fit the budget,
    which no route falls back on."""
    if P < 1 or nw < 1:
        raise ValueError(f"the batch fill needs a pair and a word, got {P} pairs, {nw} words")
    if not 1 <= m_cap <= MAX_PIPE_TEXT:
        raise ValueError(f"the batch fill takes texts of 1..{MAX_PIPE_TEXT} columns, got {m_cap}")
    if blocks is not None and blocks < 1:
        raise ValueError(f"blocks must be at least 1, got {blocks}")
    if nw <= SEGMENT_MAX:
        width = 1 << (nw - 1).bit_length()
        blocks = -(-P * width // BAND) if blocks is None else int(blocks)
        return BatchPlan(width, 1, blocks, 0)
    bands = -(-nw // BAND)
    blocks = min(P * bands, SMS * BLOCKS_PER_SM) if blocks is None else int(blocks)
    if P * bands + blocks > 2**31 - 1:  # the tickets are int32
        raise ValueError(f"{P} pairs of {bands} bands over {blocks} blocks pass the int32 ticket")
    if bands == 1:
        return BatchPlan(BAND, 1, blocks, 0)
    if budget is None:
        from .band import RING_BUDGET as budget  # band imports this module
    depth = min(bands, blocks + 1, int(budget) // (P * m_cap))
    if depth < 2:
        raise torch.OutOfMemoryError(
            f"{P} rings of 2 rows of {m_cap} columns take {2 * P * m_cap} bytes, past the "
            f"budget of {budget} bytes of device memory")
    return BatchPlan(BAND, bands, blocks, depth)


def batch_fill(texts: torch.Tensor, tlen: torch.Tensor, eq: torch.Tensor, nq: int, g: int,
               blocks: Optional[int] = None) -> torch.Tensor:
    """The batch fill's final columns (K5's contract,
    :func:`batch_fill_plain`) on the device of its tensors: the CUDA kernel
    ``bitpal_batch_fill`` (``csrc/bitpal_batch.cu``), the whole batch in
    one launch, short pairs as segments of a warp and long ones as bands
    over many blocks (:func:`batch_plan`), for CUDA tensors;
    :func:`batch_fill_plain` for CPU tensors.

    ``blocks``: the launch's blocks (:func:`batch_plan`'s default where
    None); it never changes the result.  On CUDA it allocates the output,
    then the rings (within ``band.ring_budget``: ``torch.OutOfMemoryError``
    past it) and the flags, launches on the current stream without
    synchronising, counts the launch in ``launch.bitpal_batch_fill`` and
    keeps its plan in ``batch_fill.last_plan``.  A launch the device refuses
    raises; nothing falls back to the plain version."""
    _check_batch_args(texts, tlen, eq, nq)
    _check_g(g)
    _check_blocks(blocks)
    if texts.device.type == "cpu":
        return batch_fill_plain(texts, tlen, eq, nq, g)
    if texts.device.type != "cuda":
        raise ValueError(f"the fills run on cpu or cuda tensors, got {texts.device}")
    from .band import ringed  # band imports this module
    P, m_cap = texts.shape
    nw = eq.shape[2]
    dev = texts.device
    lib = _build.load()

    def scratch(plan):
        with trace.span("alloc"):
            planes = torch.empty((P, n_planes(g), nw), dtype=torch.int64, device=dev)
            ring = (torch.empty((P, plan.depth, m_cap), dtype=torch.uint8, device=dev)
                    if plan.depth else None)
            sync = (torch.zeros(1 + P * plan.bands, dtype=torch.int32, device=dev)
                    if plan.width == BAND else None)
        trace.count_bytes("alloc_bytes", planes, ring, sync)
        return planes, ring, sync

    # only two bands or more take a ring
    plan, (planes, ring, sync) = ringed(
        dev, lambda budget: batch_plan(P, nw, m_cap, blocks, budget), scratch, nw > BAND)
    with trace.span("launch.bitpal_batch_fill"), torch.cuda.device(dev):
        err = lib.bitpal_batch_fill(
            texts.data_ptr(), m_cap, tlen.data_ptr(), eq.data_ptr(), P, nw, g, plan.blocks,
            None if ring is None else ring.data_ptr(), plan.depth,
            None if sync is None else sync.data_ptr(), planes.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"bitpal_batch_fill launch failed with CUDA error {err}")
    trace.count("launch.bitpal_batch_fill")
    batch_fill.last_plan = plan
    return planes


batch_fill.last_plan = None


def _batch_scores(planes: torch.Tensor, mt: torch.Tensor, nq: torch.Tensor, g: int,
                 cfg: ScoringConfig) -> torch.Tensor:
    """``(P,)`` int64 scores under ``cfg`` from the batch fill's planes:
    each pair's final column summed over its own ``nq[p]`` rows
    (:func:`row_deltas`), ``H(nq, mt) = sum enc - g (mt + nq)`` in the unit
    scheme, mapped back by :func:`_from_unit`."""
    P, _, nw = planes.shape
    shifts = torch.arange(WORD, device=planes.device)
    enc = sum(((planes[:, b, :, None] >> shifts) & 1) << b for b in range(planes.shape[1]))
    rows = torch.arange(nw * WORD, device=planes.device)
    total = enc.reshape(P, -1).masked_fill(rows >= nq.view(-1, 1), 0).sum(1)
    return _from_unit(cfg, mt + nq, total - g * (mt + nq))


def score_batch(texts, queries, cfg: ScoringConfig = ScoringConfig(), *,
                device) -> np.ndarray:
    """Scores of the pairs ``(texts[p], queries[p])`` under a (1, 0, -g)
    family config on ``device`` (``"cuda"`` runs one launch of the batch
    kernel, ``"cpu"`` the plain version), as ``(P,)`` int64: the
    counterpart of ``tpualign.ops.bitpal.score_batch``, each query on the
    bit axis of its pair.

    Refuses what ``tpualign.ops.bitpal.score_batch_fn`` refuses outside the
    TPU's memory caps (ValueError: a config outside the family, the int32
    headroom rule over the longest text and query), and a query bucket past
    one block (:func:`kernel_geometry`).  A pair with an empty side scores
    ``gap * (m + n)`` in closed form; codes are 0..4, and code 0 matches 0
    (``tpualign``'s batch kernel builds no plane for it)."""
    m, n = packing.batch_lengths(texts, queries)
    if not m.size:
        return np.zeros(0, np.int64)
    fam = family(cfg)
    if fam is None:
        raise ValueError(_NOT_FAMILY)
    mult, g = fam
    m_cap, n_cap = max(1, int(m.max())), max(1, int(n.max()))
    if (abs(cfg.mismatch) + 2 * mult * g) * (m_cap + n_cap) >= 2**31:
        raise ValueError("scoring magnitudes too large for int32 headroom")
    nw = -(-n_cap // WORD)
    kernel_geometry(nw)  # refuses a query bucket past one block
    dev = _device(device)
    out = cfg.gap * (m + n)
    live = (m > 0) & (n > 0)
    if not live.any():
        return out
    pairs = packing.pack_pairs(texts, queries, np.flatnonzero(live))
    codes = torch.cat([pairs.texts, pairs.queries])
    if int(codes.min()) < 0 or int(codes.max()) >= ALPHABET:
        raise ValueError("bitpal scores .bdna codes 0..4")
    with trace.span("to_device"):
        pairs = pairs.to(dev)
    texts_pad, mt, eq, nq = batch_inputs(pairs)
    planes = batch_fill(texts_pad, mt, eq, pairs.n_cap, g)
    with trace.span("reduce"):
        scores = _batch_scores(planes, mt, nq, g, cfg)
    with trace.span("read_back"):
        out[live] = scores.cpu().numpy()
    return out


def batch_inputs(pairs: packing.Pairs):
    """The batch fill's arguments for packed pairs, on their device:
    ``(texts, tlen, eq, nq)``, the texts padded to ``(P, m_cap)`` int8,
    their lengths, the match planes of the queries over ``ceil(n_cap /
    64)`` words, and the query lengths (int64) (the span ``planes``)."""
    with trace.span("planes"):
        mt, nq = pairs.lengths[0].long(), pairs.lengths[1].long()
        texts = packing.pad_pairs(pairs.texts, pairs.offsets[0], mt,
                                  pairs.m_cap).to(torch.int8)
        queries = packing.pad_pairs(pairs.queries, pairs.offsets[1], nq,
                                    -(-pairs.n_cap // WORD) * WORD, fill=-1)
        return texts, mt, _eq_planes_batch(queries), nq
