"""Command-line drivers of the port (the counterparts of ``scripts/``):
``train_zoo`` (train, validate, export and score the agent zoo),
``train_butterfly_demo`` and ``reeval_sac``.  Each runs on the card unless
given ``--device cpu`` and writes under its ``--out``, never into the
repository's ``artifacts/``."""
