"""Engines of the port: ``bitpal``, the bit-parallel score (CUDA kernel and
its plain PyTorch version)."""
