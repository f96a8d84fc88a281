"""tpualign_torch: the PyTorch and CUDA port of tpu-align.

The JAX package ``tpualign`` stays the reference; this package imports
``torch`` and nothing of ``jax`` or of ``tpualign`` (it carries its own
scoring config and NumPy oracle, held to the reference's by the tests).
Kernels are written by hand for
NVIDIA Hopper under ``csrc/`` and built with ``nvcc`` at first use; each has
a plain PyTorch version that runs on CPU tensors.

Public API:

- :func:`align_score` — alignment score of one pair, any scoring config.
- :func:`align` — score plus aligned strings of one pair.
- :func:`align_score_batch` — scores of many pairs in one kernel launch.
- :class:`ScoringConfig`, :class:`EngineConfig`, :class:`AlignMode` — config.

``python -m tpualign_torch score|align|generate|bench|info`` is its command
line (:mod:`tpualign_torch.cli`); :mod:`tpualign_torch.utils.native` its host
C++ (the leaf walks); :mod:`tpualign_torch.trace` its one recorder of spans
and counters.
"""

from . import trace
from .api import align, align_score, align_score_batch
from .config import AlignMode, EngineConfig, ScoringConfig

__all__ = ["AlignMode", "EngineConfig", "ScoringConfig", "align", "align_score",
           "align_score_batch"]
