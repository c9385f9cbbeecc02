"""The LM stack: layers, attention, blocks and the decoder model (serving path)."""
