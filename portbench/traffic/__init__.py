"""The traffic mixes (``<mix>.json``, the parameters one driver reads) and
their drivers (``<driver>.py``), each found by name."""
