"""optim substrate: AdamW with its schedule and clipping (`optimizer.py`) and
the int8 gradient quantizer with error feedback (`grad_compression.py`)."""
