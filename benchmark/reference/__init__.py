"""The benchmark's plain reference: scores by a row scan in plain PyTorch
(:mod:`.linear`) and the check of an alignment's strings in NumPy
(:mod:`.alignment`).  It imports torch and numpy only, nothing of the program,
and works out everything it compares from the inputs the benchmark made."""
