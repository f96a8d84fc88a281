"""Bit-parallel NW score for the reference's scoring (1, 0, -1), in PyTorch
and CUDA: the port of ``tpualign/ops/bitpal.py``'s flagship path.

The algorithm is the JAX module's (its docstring derives it): the vertical
DP deltas ``v = H(i, j) - H(i-1, j)`` lie in {-1, 0, 1, 2} and are carried as
two bit planes of ``enc = v + 1``; one column step advances a whole word of
query rows with boolean plane algebra and one carry-propagating add; the
score is ``H(nq, mt) = -mt + sum_i v(i, mt)`` over the final column.

The port's geometry, not the TPU's:

- 64 query rows per 64-bit word: row ``64w + b`` is bit ``b`` of word ``w``,
  and a plane is a flat ``(nw,)`` int64 tensor in word order.  No bit is
  reserved for the carry (a carry out of bit 63 is dropped; the promotion
  reaches the next word through its bottom ``h_out``).
- Five match planes, one per code 0..4, so that code 0 (the ``.bdna`` gap
  byte) matches 0 as in ``tpualign.ops.oracle``.  Rows past ``nq`` match
  nothing.
- Word ``w`` computes column ``d - w`` at step ``d``: a plain wavefront, with
  none of the TPU schedule's stagger, delay lines or lane rolls.

The kernel (``csrc/bitpal_fill.cu``) and its plain version
(:func:`fill_plain`) share this contract, so they compare word for word;
:func:`fill` picks between them by the device of its tensors.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import _build
from ..config import ScoringConfig

WORD = 64  # query rows per int64 word
ALPHABET = 5  # match planes for codes 0..4 (.bdna: 0 = gap byte, 1..4 = ATGC)
#: largest reduced gap weight of the (1, 0, -g) family (``tpualign``'s MAX_G);
#: the port runs g = 1 only so far
MAX_G = 7
#: kernel geometry: one block of up to MAX_THREADS threads, each owning K
#: consecutive words, K a power of two up to MAX_K (registers per thread)
MAX_THREADS = 1024
MAX_K = 16

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
    """``(k, threads)`` of the one-block kernel for ``nw`` words: the fewest
    words per thread that fit the block.  Raises ValueError past
    ``MAX_THREADS * MAX_K`` words (a multi-block wavefront is later work)."""
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

    The port's cost model is its kernel's: the block runs ``mt + threads - 1``
    steps and each thread works through its ``k`` words per step, threads in
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


def _plane_step(E, b0, b1, u0, u1):
    """One column step of every word at once (tensors of int64 words).

    ``(b0, b1)``: vertical-delta planes; ``(u0, u1)``: enc of the horizontal
    delta entering each word's top row.  Returns the new planes and the enc
    bits of each word's bottom-row ``h_out``.  Same algebra as the kernel's
    ``plane_step`` and ``tpualign.ops.bitpal._plane_step``; int64 adds wrap
    and shifts drop bits exactly as uint64 ones do, and ``>> 63`` is masked
    with ``& 1`` because it is arithmetic on negative words."""
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
    return b0n, b1n, (U0 >> 63) & 1, (U1 >> 63) & 1


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


def fill_plain(text: torch.Tensor, eq: torch.Tensor, nq: int):
    """Plain PyTorch version of the fill (the K1 contract): the final
    column's vertical-delta planes ``(b0, b1)``, ``enc = v + 1``.

    ``text``: ``(mt,)`` int8 codes; ``eq``: ``(5, nw)`` int64 match planes
    (:func:`_eq_planes`).  A vectorised wavefront: step ``d`` runs a few
    tensor ops over all words, word ``w`` at column ``d - w``, taking its
    ``h_top`` from the ``h_out`` word ``w - 1`` produced one step earlier.
    Words outside their columns ``1..mt`` keep their state; the h_out they
    produce feeds only words that are outside their columns too."""
    _check_fill_args(text, eq, nq)
    nw, mt = eq.shape[1], text.shape[0]
    dev = eq.device
    codes = text.long()
    # code ALPHABET selects an all-zero plane: codes outside 0..4 and the
    # padding around the text match nothing
    codes = torch.where((codes >= 0) & (codes < ALPHABET), codes, ALPHABET)
    eqx = torch.cat([eq, eq.new_zeros(1, nw)])
    pad = torch.full((nw,), ALPHABET, dtype=torch.int64, device=dev)
    off = torch.zeros(nw, dtype=torch.bool, device=dev)
    on = torch.ones(mt, dtype=torch.bool, device=dev)
    # reversed padded text: word w at step d reads rev[mt + nw - d + w], the
    # code of column d - w, so each step's codes are one contiguous slice
    rev = torch.cat([pad, codes, pad]).flip(0)
    live_rev = torch.cat([off, on, off]).flip(0)
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    b0 = torch.zeros(nw, dtype=torch.int64, device=dev)  # column 0: enc 0
    b1 = torch.zeros_like(b0)
    h0 = torch.zeros_like(b0)
    h1 = torch.zeros_like(b0)
    for d in range(1, mt + nw):
        lo = mt + nw - d
        E = eqx.gather(0, rev[lo : lo + nw].unsqueeze(0)).squeeze(0)
        live = live_rev[lo : lo + nw]
        # word 0's h_top is the top boundary h = gap: enc 0
        u0 = torch.cat([zero, h0[:-1]])
        u1 = torch.cat([zero, h1[:-1]])
        b0n, b1n, h0, h1 = _plane_step(E, b0, b1, u0, u1)
        b0 = torch.where(live, b0n, b0)
        b1 = torch.where(live, b1n, b1)
    return b0, b1


def fill(text: torch.Tensor, eq: torch.Tensor, nq: int):
    """The fill on the device of its tensors: the CUDA kernel
    (``csrc/bitpal_fill.cu``) for CUDA tensors, :func:`fill_plain` for CPU
    tensors.  Same arguments and result as :func:`fill_plain`.

    On CUDA it allocates the outputs, launches on the current stream without
    synchronising, and counts the launch in ``fill.launches``.  A launch the
    device refuses raises; nothing falls back to the plain version."""
    _check_fill_args(text, eq, nq)
    if text.device.type == "cpu":
        return fill_plain(text, eq, nq)
    if text.device.type != "cuda":
        raise ValueError(f"fill runs on cpu or cuda tensors, got {text.device}")
    nw, mt = eq.shape[1], text.shape[0]
    k, threads = kernel_geometry(nw)
    lib = _build.load()
    b0 = torch.empty(nw, dtype=torch.int64, device=text.device)
    b1 = torch.empty_like(b0)
    with torch.cuda.device(text.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.bitpal_fill(
            text.data_ptr(), eq.data_ptr(), mt, nw, k, threads,
            b0.data_ptr(), b1.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"bitpal_fill launch failed with CUDA error {err}")
    fill.launches += 1
    return b0, b1


fill.launches = 0


def _eq_planes(query: torch.Tensor, nq: int) -> torch.Tensor:
    """``(5, nw)`` int64: bit ``b`` of word ``w`` of plane ``c`` set iff
    ``query[64w + b] == c``; rows past ``nq`` are set in no plane."""
    nw = -(-nq // WORD)
    dev = query.device
    q = torch.full((nw * WORD,), -1, dtype=torch.int64, device=dev)
    q[:nq] = query
    hits = q.view(1, nw, WORD) == torch.arange(ALPHABET, device=dev).view(-1, 1, 1)
    # distinct powers of two never carry, so the sum is the OR (bit 63 wraps
    # to the sign bit as intended)
    weights = torch.ones(WORD, dtype=torch.int64, device=dev) << torch.arange(WORD, device=dev)
    return (hits.long() * weights).sum(-1)


def row_deltas(b0: torch.Tensor, b1: torch.Tensor, nq: int) -> torch.Tensor:
    """``(nq,)`` int64: the final column's ``v(i, mt)`` for each query row,
    ``enc - 1`` read back from the port's 64-row planes."""
    shifts = torch.arange(WORD, device=b0.device)
    bit0 = ((b0.unsqueeze(1) >> shifts) & 1).reshape(-1)[:nq]
    bit1 = ((b1.unsqueeze(1) >> shifts) & 1).reshape(-1)[:nq]
    return bit0 + 2 * bit1 - 1


def planes_from_jax(b0, b1, nq: int):
    """The port's ``(nw,)`` int64 planes from K1's: ``tpualign``'s
    ``(rows, 128)`` int32 planes (numpy), 31 rows per word, word ``w`` at
    ``(w % rows, w // rows)``; bit 31 of every word and the rows past ``nq``
    in the last word are ignored."""
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

    return convert(b0), convert(b1)


def _reduce_score(b0, b1, nq: int, mt: int) -> torch.Tensor:
    """Unit-scheme score ``H(nq, mt) = -mt + sum_i v(i, mt)``."""
    return row_deltas(b0, b1, nq).sum() - mt


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


def score_fn(m: int, n: int, cfg: ScoringConfig = ScoringConfig(), *, device):
    """``(s1, s2) -> score`` for fixed lengths ``m = len(s1)``,
    ``n = len(s2)``: takes int8 code tensors on ``device`` and returns the
    score as a 0-d int64 tensor there, without synchronising.

    Refuses what ``tpualign.ops.bitpal.score_fn`` refuses (ValueError for a
    config outside the family or past the int32 headroom rule, kept so both
    packages refuse the same inputs), and raises NotImplementedError for the
    g >= 2 members the port does not run yet."""
    fam = family(cfg)
    if fam is None:
        raise ValueError(_NOT_FAMILY)
    mult, g = fam
    # the JAX package maps scores in int32 on device; the port computes in
    # int64 but refuses the same inputs
    if (abs(cfg.mismatch) + 2 * mult * g) * (m + n) >= 2**31:
        raise ValueError("scoring magnitudes too large for int32 headroom")
    if g != 1:
        raise NotImplementedError(
            f"the (1, 0, -{g}) family is not ported yet: ROADMAP queue 1 "
            "item 6 (kernel K2)"
        )
    dev = _device(device)
    if m == 0 or n == 0:
        return lambda s1, s2: torch.tensor(cfg.gap * (m + n), device=dev)
    s1_is_query = _orientation(m, n)
    nq, mt = (m, n) if s1_is_query else (n, m)

    def fn(s1: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
        if (s1.numel(), s2.numel()) != (m, n):
            raise ValueError(f"score_fn built for lengths ({m}, {n}), got "
                             f"({s1.numel()}, {s2.numel()})")
        query, text = (s1, s2) if s1_is_query else (s2, s1)
        b0, b1 = fill(text, _eq_planes(query, nq), nq)
        return _from_unit(cfg, mt + nq, _reduce_score(b0, b1, nq, mt))

    return fn


def _codes(seq) -> np.ndarray:
    a = np.asarray(seq)
    if a.ndim != 1:
        raise ValueError(f"sequence must be 1-D, got shape {a.shape}")
    if a.size and (a.min() < 0 or a.max() >= ALPHABET):
        raise ValueError("bitpal scores .bdna codes 0..4")
    return np.ascontiguousarray(a, dtype=np.int8)


def score(s1, s2, cfg: ScoringConfig = ScoringConfig(), *, device) -> int:
    """NW score of two code sequences on ``device`` (``"cuda"`` runs the
    kernel, ``"cpu"`` the plain version); the counterpart of
    ``tpualign.ops.bitpal.score``."""
    s1, s2 = _codes(s1), _codes(s2)
    dev = _device(device)
    fn = score_fn(s1.size, s2.size, cfg, device=dev)
    return int(fn(torch.from_numpy(s1).to(dev), torch.from_numpy(s2).to(dev)))
