"""Hand-written CUDA kernels for the Task Bench hot spots.

Each kernel lives in ``csrc/<name>.cu`` (built by ``_build``), has a
wrapper beside its plain PyTorch version in ``<name>.py`` (the blocked
megakernel's sits with the single-step one's in ``taskbench_step.py``),
an independent oracle in ``ref.py``, and a public wrapper in ``ops.py``
that runs the plain version on a CPU tensor and the kernel on a CUDA
tensor.
"""
from repro_torch.kernels import ops, ref  # noqa: F401
