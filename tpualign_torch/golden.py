"""Golden scores of the corpus pairs: the port's copy of
``tpualign/golden.py``'s pins (``tests/test_torch_cli.py`` holds the two
equal), for ``python -m tpualign_torch bench --check golden``, which refuses
to emit a row whose score mismatches its pin.

The unit pins were produced by the reference's own serial kernel
(``src/serial/serial.cpp`` and its main program, compiled with
``g++ -O2 -std=c++11``) on the corpus pair of that name, under its
compiled-in scoring (MATCH=1, MISMATCH=0, GAP=-1, global,
``needleman-wunsch.hpp:11-13``).
"""

#: corpus pair name -> reference serial binary's printed ``Score:``
GOLDEN_NW_UNIT = {
    "small": 2,
    "debug": 27,
    "t": 17,
    "smid": 5839,
    "2gb": 12958,
    "4gb": 18461,
    "8gb": 26186,
    "12gb": 32027,
    "16gb": 36980,
    "24gb": 45131,
    "32gb": 52216,
    "40gb": 57883,
    "48gb": 64070,
    "64gb": 73888,
}

#: Smith-Waterman pins for the benchmark config (match=2, mismatch=-1,
#: gap=-2, local).  SELF-PINNED: the reference never implements SW
#: (README.md:2 announces it; no kernel exists), so these come from the
#: JAX package's independent C++ scorer (``native/bdna_tools.cpp:align_score_native``,
#: a plain int64 row scan sharing no code with the device engines), so that
#: no SW number rests only on the engine that produced it.
GOLDEN_SW_2_1_2 = {
    "small": 9,
    "debug": 44,
    "t": 25,
    "smid": 9533,
    "2gb": 21094,
    "4gb": 30148,
    "8gb": 42564,
    "12gb": 52291,
    "16gb": 59832,
    "24gb": 73458,
    "32gb": 84735,
    "40gb": 93805,
    "48gb": 104056,
    "64gb": 119785,
}
