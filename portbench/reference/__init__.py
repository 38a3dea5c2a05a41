"""The plain reference of the benchmark: the pedestrian Link Transmission
Model step, its host scenario build, its per-replica randomization and the
RL env's actions, observations and rewards, in plain PyTorch and NumPy.

It is a frozen copy of the program's plain code paths, with every kernel
replaced by its plain version (the history reads, the fast binomial, the
routed turning fractions), and it imports nothing of the program: it
builds its own scenario tables from the raw files under ``data/``, so the
comparison that decides ``correct`` judges the program's outputs against
arithmetic that the program did not make.
"""
