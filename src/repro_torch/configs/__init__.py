"""Model configs: copies of ``repro.configs`` (shapes only; weights are random)."""
