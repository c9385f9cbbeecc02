"""checkpoint substrate: atomic tensor-tree checkpoints (`checkpointer.py`)
and the restart loop around them (`elastic.py`), in the reference's
on-disk format."""
