"""Launch shapes of K1 and K3, sized from the element count and the SM count.

A thread owns ``chains`` consecutive elements (K3: columns of one row),
its independent FMA chains: VEC (one 16-byte vector of f32) where there
are enough elements to fill the card, else 1. `cut_ctas` cuts the threads
into CTAs so that every SM gets work. K1's `compute_plan` and K3's
`step_plan` are built from these.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

#: Elements (columns, for K3) a thread owns where there are many: one
#: 16-byte vector of f32, its independent FMA chains.
VEC = 4
#: The largest CTA `cut_ctas` takes.
MAX_THREADS = 256
#: Elements an SM must have for VEC-chain threads to give each of its 4
#: sub-partitions a full warp (4 x 32 lanes x VEC); with fewer, a thread
#: takes one element, so that its chains spread over the sub-partitions
#: (a lone warp of VEC chains is bound by its issue rate, not the latency).
#: The crossover is measured, not only reasoned (``kernel_variants --kernel
#: k1|k3``, 132 to 2112 rows, PERF.md): at FILL an SM 4 chains are the
#: faster, below it 1; at 1.5 x FILL 1 chain is ~4% faster at grain 16384
#: and 4 chains faster at grain 64, so no one threshold wins there.
FILL = 4 * 32 * VEC


class LaunchPlan(NamedTuple):
    """``chains`` elements (K3: columns) a thread, ``threads`` per CTA,
    ``ctas`` in all."""

    chains: int
    threads: int
    ctas: int


def chains_for(elements: int, sms: int) -> int:
    """Elements a thread owns: VEC where every SM gets FILL of them, else 1."""
    return VEC if elements >= sms * FILL else 1


def cut_ctas(items: int, sms: int, groups: int = 1) -> tuple:
    """(threads per CTA, CTAs) for ``groups`` x ``items`` threads of work (a
    group per grid row: K3's members), each group's threads cut into CTAs
    of one size: MAX_THREADS, or fewer where that leaves an SM without a
    CTA (the threads over the SMs, rounded down), so that any launch of at
    least ``sms`` threads gives every SM work."""
    threads = max(1, min(MAX_THREADS, items * groups // max(1, sms)))
    return threads, groups * -(-items // threads)


@lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def aligned(*tensors: torch.Tensor) -> bool:
    """Whether every tensor's data starts on a 16-byte boundary."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)
