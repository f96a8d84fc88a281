"""The benchmark of ``tpualign_torch``, the PyTorch and CUDA port.

One command runs one cell once (``python3 benchmark/run.py --workload
<name> --seed <n> --seconds <s> --trace <0|1>``).  Everything a cell is made
of is found by name from ``BENCHMARK.json``: its configuration in
``configs/``, its traffic in ``traffic/``, each metric's reader in
``metrics/``.  The yardstick (the generator, the plain reference, the
roofline's counts and peaks, the comparison that decides ``correct``) lives
here and imports nothing of the program.  See ``README.md``.
"""
