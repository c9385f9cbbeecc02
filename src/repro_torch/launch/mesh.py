"""The 2D (row, member) mesh of K-sharded stacked ensembles.

Counterpart of ``repro.launch.mesh.make_row_member_mesh``. The port's row
mesh is a `_halo.ShardMesh`: D devices, each shard computing on its own
stream. The (row, member) mesh reshapes the D devices to a (Dr, Dk) grid,
row axis first, so device (i, j) is ``devices[i*Dk + j]``, and keeps one
row ring a member column: ring j is a `ShardMesh` over ``devices[j],
devices[Dk + j], ...``. The K members split Dk ways, member slice j living
on ring j, and every row transport runs inside one ring, never across the
member axis, as a named-axis collective spans only its own axis in the
reference's mesh.

Each ring makes its own streams, so the D shards keep D distinct stream
pairs where the device list names one card D times. ``fork`` and ``join``
span every ring, so a capture records all D shards as parallel branches.

The reference's other mesh builders and its TPU v5e constants describe a
TPU pod and have no counterpart here (ROADMAP.md, Queue 1 items 12 and 13).
"""
from __future__ import annotations

from typing import List, Sequence

from repro_torch.core.runtimes._halo import ShardMesh


class RowMemberMesh:
    """The Dk row rings of a (Dr, Dk) grid over D devices (see the module
    docstring); ``rings[j]`` holds member slice j."""

    def __init__(self, rings: Sequence[ShardMesh]):
        self.rings: List[ShardMesh] = list(rings)

    def fork(self) -> None:
        """Every ring's streams ordered after the caller's (a run's start)."""
        for ring in self.rings:
            ring.fork()

    def join(self, outputs: Sequence = ()) -> None:
        """The caller's stream ordered after every ring's streams (a run's
        end); ``outputs[j]``, where given, a state over ring j's shards,
        marked as used there."""
        outputs = list(outputs) or [None] * len(self.rings)
        for ring, out in zip(self.rings, outputs):
            ring.join(*([] if out is None else [out]))


def make_row_member_mesh(devices: Sequence, member_shards: int) -> RowMemberMesh:
    """The (row, member) mesh of ``devices`` at Dk = ``member_shards``: the
    Dk rings of Dr = len(devices) / Dk devices. A Dk that does not divide
    the device count is refused with the fallback named, as the
    reference's builder refuses it."""
    devices = list(devices)
    count = len(devices)
    dk = int(member_shards)
    if dk < 1 or count % dk:
        raise ValueError(
            f"2D (row, member) mesh needs member_shards to divide the "
            f"device count: {count} devices cannot split into "
            f"(rows, members) = ({count / dk if dk else '?'}, {dk}). "
            f"Pass member_shards=1 (or a divisor of {count}) to fall "
            f"back to the replicated 1D row mesh.")
    return RowMemberMesh([ShardMesh(devices[j::dk]) for j in range(dk)])
