"""Runtime backends; importing ``repro_torch.core`` registers them."""
