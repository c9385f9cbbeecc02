"""data substrate: the deterministic synthetic token pipeline (`pipeline.py`)."""
