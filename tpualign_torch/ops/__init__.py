"""Engines of the port: ``bitpal``, the bit-parallel (1, 0, -g) fills;
``band``, the general-scoring strip score; ``pallas_diag``, the flat
anti-diagonal score (CUDA kernels and their plain PyTorch versions);
``xla``, the PyTorch row scan (the portable engine and the plain version of
``band`` and ``pallas_diag``); ``hirschberg``, alignment by divide and
conquer over the bit-parallel fills; ``traceback_diag``, alignment with the
reference's tie order over the checkpointed diagonal fill; ``traceback``,
the checkpointed row-scan traceback (``impl="oracle"``/``"xla"`` and the
last fallback); ``oracle``, the NumPy row scan and full-table traceback."""
