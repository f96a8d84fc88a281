"""Configuration of the PyTorch port.

:class:`ScoringConfig` and :class:`AlignMode` carry the scoring semantics of
``tpualign.config`` field for field (same names, defaults and validation;
``tests/test_torch_api.py`` holds the two to each other).  The port keeps its
own copy so that nothing it imports belongs to the JAX package.
:class:`EngineConfig` is the port's own: it knows other engine names than
the JAX package's, and it names the device the work runs on.
"""

from __future__ import annotations

import dataclasses
import enum

import torch

__all__ = ["AlignMode", "EngineConfig", "ScoringConfig"]

#: the engines of ``tpualign``'s ``EngineConfig`` that the port runs;
#: ``auto`` resolves by scoring config and ``band-chunked`` to ``band``
#: (:func:`tpualign_torch.api.resolve_impl`)
IMPLS = ("auto", "bitpal", "band", "pallas", "xla", "oracle", "band-chunked")

#: ``tpualign``'s other engines, accepted by name and refused by
#: :func:`tpualign_torch.api.resolve_impl` with the ROADMAP item that ports
#: them
UNPORTED_IMPLS = {
    "bitpal-strips": "ROADMAP queue 1 item 13 (sharded pipelines)",
    "band-strips": "ROADMAP queue 1 item 13 (sharded pipelines)",
    "strips": "ROADMAP queue 1 item 13 (sharded pipelines)",
}


class AlignMode(enum.Enum):
    """Alignment mode: ``GLOBAL`` (Needleman-Wunsch), ``LOCAL``
    (Smith-Waterman), ``SEMIGLOBAL`` (leading and trailing gaps free in
    either sequence) and ``INFIX`` (all of ``s2`` inside any substring of
    ``s1``)."""

    GLOBAL = "nw"
    LOCAL = "sw"
    SEMIGLOBAL = "sg"
    INFIX = "infix"


@dataclasses.dataclass(frozen=True)
class ScoringConfig:
    """Scoring parameters; the defaults are the reference's match +1,
    mismatch 0, gap -1, global.

    ``matrix``: a square tuple of tuples indexed by code, ``matrix[a][b]``
    for code ``a`` of ``s1`` against ``b`` of ``s2`` (replaces ``match`` and
    ``mismatch``).  ``gap_open`` / ``gap_extend``: affine gaps, a run of L
    gap columns costs ``gap_open + L * gap_extend`` (``None``: linear gaps
    of ``gap`` each).
    """

    match: int = 1
    mismatch: int = 0
    gap: int = -1
    mode: AlignMode = AlignMode.GLOBAL
    matrix: tuple | None = None
    gap_open: int | None = None
    gap_extend: int | None = None

    def __post_init__(self) -> None:
        for name in ("match", "mismatch", "gap"):
            v = getattr(self, name)
            if not isinstance(v, int):
                raise TypeError(f"{name} must be a Python int, got {type(v)}")
        if not isinstance(self.mode, AlignMode):
            raise TypeError(f"mode must be AlignMode, got {type(self.mode)}")
        if self.matrix is not None:
            m = self.matrix
            if not isinstance(m, tuple) or not m or not all(
                isinstance(r, tuple) and len(r) == len(m) for r in m
            ):
                raise TypeError("matrix must be a square tuple-of-tuples")
            if len(m) > 16:
                raise ValueError("matrix alphabet too large (max 16 codes)")
            if not all(isinstance(v, int) for r in m for v in r):
                raise TypeError("matrix entries must be Python ints")
        if (self.gap_open is None) != (self.gap_extend is None):
            raise ValueError("gap_open and gap_extend must be set together")
        if self.gap_open is not None:
            for name in ("gap_open", "gap_extend"):
                v = getattr(self, name)
                if not isinstance(v, int):
                    raise TypeError(f"{name} must be a Python int, got {type(v)}")
                if v > 0:
                    raise ValueError(f"{name} must be <= 0, got {v}")

    @property
    def is_local(self) -> bool:
        return self.mode is AlignMode.LOCAL

    @property
    def is_affine(self) -> bool:
        return self.gap_open is not None

    @property
    def has_matrix(self) -> bool:
        return self.matrix is not None

    # ends-free boundaries: ``free_start_s1``/``free_end_s1`` make the first
    # and last rows free (H(0, j) = 0, score maxed over the last row);
    # ``free_start_s2``/``free_end_s2`` do the same for the columns
    @property
    def free_start_s1(self) -> bool:
        return self.mode in (AlignMode.SEMIGLOBAL, AlignMode.INFIX)

    @property
    def free_start_s2(self) -> bool:
        return self.mode is AlignMode.SEMIGLOBAL

    @property
    def free_end_s1(self) -> bool:
        return self.mode in (AlignMode.SEMIGLOBAL, AlignMode.INFIX)

    @property
    def free_end_s2(self) -> bool:
        return self.mode is AlignMode.SEMIGLOBAL

    @property
    def is_ends_free(self) -> bool:
        return self.mode in (AlignMode.SEMIGLOBAL, AlignMode.INFIX)

    def sub_score(self, a: int, b: int) -> int:
        """Substitution score of s1-code ``a`` against s2-code ``b``."""
        if self.matrix is not None:
            return self.matrix[a][b]
        return self.match if a == b else self.mismatch

    def sub_bounds(self) -> tuple:
        """(min, max) substitution score over the alphabet."""
        if self.matrix is not None:
            return (min(min(r) for r in self.matrix),
                    max(max(r) for r in self.matrix))
        return (min(self.match, self.mismatch),
                max(self.match, self.mismatch))

    def with_mode(self, mode: AlignMode) -> "ScoringConfig":
        return dataclasses.replace(self, mode=mode)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Execution strategy of the port.

    ``impl``: ``auto``; ``bitpal`` (the bit-parallel (1, 0, -g) engine),
    ``band`` (the general-scoring strip engine) or ``pallas`` (the flat
    anti-diagonal engine), each a CUDA kernel on a CUDA device and its
    plain PyTorch version on the CPU; ``xla`` (the PyTorch row scan on the
    device) or ``oracle`` (the NumPy row scan on the host).  The names are
    ``tpualign``'s; :data:`UNPORTED_IMPLS` are accepted and refused when
    resolved.

    ``device``: a torch device string.  The default is ``"cuda"``, and a run
    with it on a machine without CUDA raises: nothing falls back to the CPU
    on its own.  Pass ``"cpu"`` for the plain PyTorch path.
    """

    impl: str = "auto"
    device: str = "cuda"

    def __post_init__(self) -> None:
        if self.impl not in IMPLS and self.impl not in UNPORTED_IMPLS:
            raise ValueError(f"unknown impl {self.impl!r}; expected one of "
                             f"{IMPLS + tuple(UNPORTED_IMPLS)}")
        if torch.device(self.device).type not in ("cpu", "cuda"):
            raise ValueError(f"device must be a cpu or cuda device, got {self.device!r}")


def ensure_pair_modes(cfg: ScoringConfig, engine: str) -> None:
    """ValueError for matrix and ends-free configs in an engine that serves
    pair-scored global and local configs only, as
    ``tpualign.config.ensure_pair_modes``."""
    if cfg.has_matrix or cfg.is_ends_free:
        raise ValueError(
            f"{engine} serves pair-scored global/local configs; "
            "matrix/ends-free configs run on the band or xla engines")
