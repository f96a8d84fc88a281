"""Sequence IO of the port (the .bdna corpus format)."""

from .bdna import (
    BASES,
    decode,
    encode,
    pair_lengths_for_gb,
    random_pair,
    read_bdna,
    table_gb,
    write_bdna,
)

__all__ = [
    "BASES",
    "decode",
    "encode",
    "pair_lengths_for_gb",
    "random_pair",
    "read_bdna",
    "table_gb",
    "write_bdna",
]
