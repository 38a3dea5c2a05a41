"""Command-line drivers of the port (the counterparts of ``scripts/`` and
of ``network_dashboard.py``): ``train_zoo`` (train, validate, export and
score the agent zoo), ``train_butterfly_demo``, ``reeval_sac``,
``retrain_r3`` (the zoo retrain by phase), ``ablate_global_reward``, the
throughput sweeps ``sweep_melbourne`` and ``sweep_grid``,
``quantify_window`` (windowed against full-horizon rings),
``reset_determinism_report`` and ``network_dashboard`` (reads saved runs,
touches no device).  Each of the others runs on the card unless given
``--device cpu`` and writes under its ``--out``, never into the
repository's ``artifacts/``."""
