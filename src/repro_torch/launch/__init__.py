"""Entry points of the port's LM stack: ``serve`` (prefill + decode loop)."""
