"""The sharded pipelines: the port of ``tpualign/parallel``.

``mesh``, the shard group and its two transports (one process, or a
``torch.distributed`` world); ``strips``, the row scan over column blocks;
``band_strips``, the strip kernel's sharded contract (K7) over column
blocks; ``bitpal_strips``, the bit-parallel chunk's sharded contract (K4)
over bands of query words."""
