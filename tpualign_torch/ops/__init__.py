"""Engines of the port: ``bitpal``, the bit-parallel (1, 0, -g) fills (CUDA
kernels and their plain PyTorch versions); ``hirschberg``, alignment by
divide and conquer over those fills; ``oracle``, the NumPy row scan and
full-table traceback."""
