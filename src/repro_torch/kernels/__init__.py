"""Hand-written CUDA kernels for the Task Bench hot spots and the LM stack.

Each kernel lives in ``csrc/<name>.cu`` (built by ``_build``) and has a
wrapper in ``<name>.py`` (the blocked megakernel's sits with the
single-step one's in ``taskbench_step.py``, K7's in ``ssd_scan.py``), a
plain PyTorch version (beside the wrapper for the Task Bench kernels, in
``ref.py`` for the LM kernels), and a public wrapper in ``ops.py`` that
runs the plain version on a CPU tensor and the kernel on a CUDA tensor.
``ref.py`` also holds independent oracles of the Task Bench kernels.
"""
from repro_torch.kernels import ops, ref  # noqa: F401
