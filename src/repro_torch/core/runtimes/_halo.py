"""The halo dataflow the bulk-synchronous backends share: the window
combine, and the transports that move rows between row shards.

Counterpart of ``repro.core.runtimes._halo``. Points are block-distributed:
shard d owns rows [d*B, (d+1)*B) of the global (W, payload) state. Halo
patterns (stencil/dom/nearest/...) reach at most ``r = halo_radius`` points
across, so one ring exchange of r edge rows per direction supplies every
remote input.

One controller drives every shard, as the reference's one process drives
its mesh: a `ShardMesh` names D devices, which may repeat one card, and
each shard's state is its own tensor on its own device. A shard reads
another shard's rows only through a transport of this module, which copies
them into a receive buffer of that shard. On one device (D = 1) there are no
shards to move rows between: ``exchange_halos`` of a single tensor is the
ring wrap, as views of the state, and ``gather_global`` the state itself.

Streams (on the card). Each shard computes on its own stream
(``ShardMesh.on(d)``) and receives on its own transfer stream. A
transport's start records an event on each shard's stream, after the rows
it sends are final; a copy into shard d waits on the events of the shards
whose rows it reads and on shard d's own (the receiver takes part in
program order, as a device does in the reference's collective permute),
so the copies into one shard do not queue behind another's.
Its join makes each shard's stream wait on the end of the transfers that
deliver rows to it or read rows from it, and on no other: under "ppermute"
shard d waits on its two neighbours' transfers, not on the whole ring (a
gather reads every shard, so there every shard waits on it). What a shard
issues between start and join runs under the transfer: the counterpart of
the reference's SSA dataflow, where "the asynchrony is the dataflow
itself". ``fork()`` at the start of a run
orders the shard and transfer streams after the caller's stream and
``join()`` at its end orders the caller's stream after them, so a capture
on the caller's stream records the D shards as parallel branches. On the
CPU every operation runs in issue order and the events are absent.

The transports, by the reference's registry names, so that ``halo_impl``
means the same in both packages:

  halo    "xla"       both edges of every shard in one packed ring buffer
                      per receiving device (one concatenation there: the
                      reference's single all-gather), each shard's halo a
                      view of it
          "ppermute"  one copy per direction per shard (the reference's
                      per-direction collective permute)
  stride  "xla"       every shard's block gathered once per device, each
                      partner block a view of that ring
          "ppermute"  one copy of the partner block per stride per shard
  gather  "xla"       the shards concatenated once per receiving device
          "ppermute"  per shard, the other D - 1 blocks copied in and the
                      ring assembled in global order
          "chunked"   segments of G shards gathered first, then the
                      segments (G: ``schedule.choose_gather_chunk_group``,
                      unless given: measured walls where the cost model has
                      them, else the divisor of D nearest sqrt(D))

Every transport moves exact row copies, so all of them give the same bits.
On one card a copy is a device-to-device copy in the card's memory; across
cards the same code makes it a peer copy. ``register_transport_impl`` adds
a transport (a counting or fault-injecting wrapper, say) to a registry, and
refuses to shadow one silently.

``make_halo_combine`` builds a combine that matches
``task_kernels.combine_dependencies`` (the mean over live deps) on every
halo pattern: its masks mirror ``patterns.dependencies`` for every edge case
(global edges, dom's asymmetry, random_nearest's keep set), indexed at the
shard's first global row p0 = d*B. It sums each window's 2r+1 terms in
another order than the padded gather does, so the two agree to f32
rounding, not bit for bit.

Every halo transport takes ``out=(heads, tails)``: shard d's received rows
then land in ``heads[d]`` and ``tails[d]``, buffers of shard d (the head
and tail rows of a persistent halo-extended buffer), and the handle's
receive lists are those buffers.

Tracing (``obs``). Every transport's start takes ``tracer=`` (default None:
it records nothing, and runs as it always does) and ``span=``, a dict of
the span's extra attributes (a "name" entry renames it). Only the traced
executors (``Runtime.trace_once``) pass one: the start then runs inside
``transport_span`` and is synchronous, joined and drained (`ShardMesh.drain`)
before the span closes, so the span covers the rows' arrival on every
shard. A production run, captured as a CUDA graph, never passes a tracer.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import patterns as _patterns
from repro_torch.core.graph import TaskGraph

Shards = Sequence[torch.Tensor]


def offset_keep(graph: TaskGraph) -> np.ndarray:
    """Which window offsets [-r..r] the pattern actually consumes."""
    r = _patterns.halo_radius(graph)
    offsets = np.arange(-r, r + 1)
    if graph.pattern == "no_comm":
        return offsets == 0
    if graph.pattern == "dom":
        return offsets <= 0
    # stencil_1d(_periodic), nearest, random_nearest: whole window
    return np.ones_like(offsets, dtype=bool)


def random_keep_table(graph: TaskGraph) -> Optional[np.ndarray]:
    """(W, 2r+1) keep mask for random_nearest; None for other patterns."""
    if graph.pattern != "random_nearest":
        return None
    r = graph.radius
    W = graph.width
    keep = np.zeros((W, 2 * r + 1), dtype=np.float32)
    for p in range(W):
        deps = set(_patterns.dependencies(graph, 1, p))
        for j, o in enumerate(range(-r, r + 1)):
            if (p + o) % W in deps:
                keep[p, j] = 1.0
    return keep


class HaloCombine:
    """``combine(ctx, n, p0) -> (n, payload)``, built by `make_halo_combine`.

    ``ctx`` holds the (n + 2r, payload) rows that give each output row its
    full window: output row i consumes ctx rows [i, i + 2r]. ``n`` is the
    number of output rows and ``p0`` the global point of output row 0 (for
    edge masking), both host integers. Each (n, p0)'s mask and denominator
    are built once, on the host, and kept on ``device``; a call is three
    device operations (weight, sum, divide) on the windows, a view of ctx.
    """

    def __init__(self, graph: TaskGraph, device):
        self.r = _patterns.halo_radius(graph)
        if self.r < 0:
            raise ValueError(f"{graph.pattern} is not halo-expressible")
        self.keep = offset_keep(graph).astype(np.float32)
        self.nonperiodic = graph.pattern in ("stencil_1d", "dom")
        self.rand = random_keep_table(graph)
        self.width = graph.width
        self.device = torch.device(device)
        self._tables: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}

    def tables(self, n: int, p0: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The (n, 1, 2r+1) mask and the (n, 1) denominator of output rows
        p0 .. p0 + n - 1."""
        if (n, p0) not in self._tables:
            r, W = self.r, self.width
            mask = np.repeat(self.keep[None, :], n, axis=0)
            if self.nonperiodic:
                q = p0 + np.arange(n)[:, None] + np.arange(-r, r + 1)[None, :]
                mask *= (q >= 0) & (q < W)
            if self.rand is not None:
                mask *= self.rand[p0:p0 + n]
            denom = np.maximum(mask.sum(-1, keepdims=True), np.float32(1.0))
            self._tables[(n, p0)] = (
                torch.from_numpy(np.ascontiguousarray(mask[:, None, :])).to(self.device),
                torch.from_numpy(denom.astype(np.float32)).to(self.device))
        return self._tables[(n, p0)]

    def __call__(self, ctx: torch.Tensor, n: int, p0: int) -> torch.Tensor:
        if self.r == 0:  # no_comm, trivial: self only
            return ctx
        mask, denom = self.tables(n, p0)
        windows = ctx.unfold(0, 2 * self.r + 1, 1)  # (n, payload, 2r+1)
        return (windows * mask).sum(-1) / denom


def make_halo_combine(graph: TaskGraph, device="cpu") -> HaloCombine:
    """The window combine of a halo pattern (see `HaloCombine`)."""
    return HaloCombine(graph, device)


# ------------------------------------------------------------------ the mesh


def _normalize(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class ShardMesh:
    """D row shards' devices and streams: the port's one-axis mesh.

    ``devices[d]`` holds shard d; an entry may repeat (D shards on one
    card). On the card each shard gets a compute stream (``on(d)``) and a
    transfer stream (``transfer(d)``), on which the copies it receives run;
    the streams are made once and reused by every run, so a capture and its
    eager loop issue the same work on the same streams. On the CPU there
    are no streams.
    """

    def __init__(self, devices: Sequence):
        self.devices = tuple(_normalize(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in self.devices}) != 1:
            raise ValueError(f"mixed device types: {self.devices}")
        self.cuda = self.devices[0].type == "cuda"
        self.distinct = tuple(dict.fromkeys(self.devices))
        self._compute: Optional[List["torch.cuda.Stream"]] = None
        self._transfer: Optional[List["torch.cuda.Stream"]] = None

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def one_card(self) -> bool:
        """Whether every shard sits on one device."""
        return len(self.distinct) == 1

    def compute(self, d: int) -> Optional["torch.cuda.Stream"]:
        """Shard d's compute stream (None on the CPU)."""
        if not self.cuda:
            return None
        if self._compute is None:
            self._compute = [torch.cuda.Stream(dev) for dev in self.devices]
        return self._compute[d]

    def transfer(self, d: int) -> Optional["torch.cuda.Stream"]:
        """Shard d's transfer stream (None on the CPU)."""
        if not self.cuda:
            return None
        if self._transfer is None:
            self._transfer = [torch.cuda.Stream(dev) for dev in self.devices]
        return self._transfer[d]

    def first_on(self, device) -> int:
        """The first shard on ``device``: a buffer gathered once per device
        is made on that shard's transfer stream."""
        return self.devices.index(_normalize(device))

    def on(self, d: int):
        """A context in which work runs on shard d's stream."""
        s = self.compute(d)
        return torch.cuda.stream(s) if s is not None else contextlib.nullcontext()

    def _streams(self):
        return [(self.devices[d], s) for d in range(self.size)
                for s in (self.compute(d), self.transfer(d))]

    def fork(self) -> None:
        """Order every shard and transfer stream after the work issued so
        far on its device's current stream (the start of a run)."""
        if not self.cuda:
            return
        for dev, s in self._streams():
            s.wait_stream(torch.cuda.current_stream(dev))

    def join(self, *outputs: Shards) -> None:
        """Order each device's current stream after every shard and
        transfer stream on it (the end of a run); each of ``outputs`` (a
        state over the shards: shard d's tensor d-th) is marked as used
        there too."""
        if not self.cuda:
            return
        for dev, s in self._streams():
            torch.cuda.current_stream(dev).wait_stream(s)
        for shards in outputs:
            for d, t in enumerate(shards):
                t.record_stream(torch.cuda.current_stream(self.devices[d]))

    def drain(self) -> None:
        """Wait, on the host, until the work issued so far on every device
        of the mesh has finished, every shard's and transfer stream's (the
        end of a traced span); nothing to wait for on the CPU."""
        if self.cuda:
            for dev in self.distinct:
                torch.cuda.synchronize(dev)

    def sent(self, shards: Sequence[int]) -> "_Transfer":
        """A transfer of rows that shards ``shards`` have issued so far."""
        return _Transfer(self, shards)


class _Transfer:
    """The copies of one transport. The copies into shard d run on shard
    d's transfer stream (a buffer gathered once per device: on its first
    shard's), each after the events (`ShardMesh.sent`) of the shards whose
    rows it reads and of the receiving shard, so it lands after that
    shard's earlier work (its reads of a buffer ``out`` overwrites
    included). ``move(src, d, sender)`` copies shard ``sender``'s rows
    ``src`` into a new receive buffer of shard d, or into ``out``, a buffer
    shard d owns. ``gather(parts, dev)``
    concatenates rows of every shard into one buffer on ``dev``, which
    ``read_by`` hands to a shard. ``done()`` gives the arrival a join waits
    on. ``slot_senders`` (per transfer stream, the shards whose events its
    copies wait on) is kept on the CPU too."""

    def __init__(self, mesh: ShardMesh, senders: Sequence[int]):
        self.mesh = mesh
        self.senders = tuple(senders)
        self.sends = ({s: mesh.compute(s).record_event() for s in self.senders}
                      if mesh.cuda else {})
        self.slot_senders: Dict[int, set] = {}
        self.streams: Dict[int, "torch.cuda.Stream"] = {}
        self.readers: List[Tuple[torch.Tensor, int, int]] = []  # (buffer, shard, slot)

    def _on(self, slot: int, senders: Sequence[int]):
        """The context of shard ``slot``'s transfer stream, ordered after
        ``senders``' events."""
        seen = self.slot_senders.setdefault(slot, set())
        new = [k for k in senders if k not in seen]
        seen.update(new)
        if not self.mesh.cuda:
            return contextlib.nullcontext(), None
        s = self.streams.setdefault(slot, self.mesh.transfer(slot))
        for k in new:
            s.wait_event(self.sends[k])
        return torch.cuda.stream(s), s

    def move(self, src: torch.Tensor, d: int, sender: int,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A copy of shard ``sender``'s ``src`` in a receive buffer of shard
        d (``out``, where given)."""
        ctx, s = self._on(d, (sender, d))
        with ctx:
            if out is None:
                out = torch.empty(src.shape, dtype=src.dtype, device=self.mesh.devices[d])
            out.copy_(src, non_blocking=True)
        if s is not None:
            src.record_stream(s)
            out.record_stream(s)
        self.readers.append((out, d, d))
        return out

    def gather(self, parts: Shards, dev: torch.device, row_axis: int = 0) -> torch.Tensor:
        """``parts`` concatenated along ``row_axis`` into one buffer on
        ``dev``: one concatenation where every part is there already,
        else each other part copied in first."""
        ctx, s = self._on(self.mesh.first_on(dev), self.senders)
        with ctx:
            here = [p if p.device == dev else p.to(dev, non_blocking=True) for p in parts]
            out = torch.cat(here, dim=row_axis)
        if s is not None:
            for p in parts:
                p.record_stream(s)
        return out

    def read_by(self, t: torch.Tensor, d: int,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``t``, made by `gather` on shard d's device, as read by shard d;
        copied into ``out``, a buffer of shard d, where given."""
        slot = self.mesh.first_on(self.mesh.devices[d])
        if out is not None:
            ctx, s = self._on(slot, self.senders)
            with ctx:
                out.copy_(t, non_blocking=True)
            if s is not None:
                out.record_stream(s)
            t = out
        self.readers.append((t, d, slot))
        return t

    def done(self) -> "_Arrival":
        ends = {slot: s.record_event() for slot, s in self.streams.items()}
        waits = {d: sorted({slot for _, r, slot in self.readers if r == d}
                           | {slot for slot, k in self.slot_senders.items() if d in k})
                 for d in range(self.mesh.size)}
        return _Arrival(self.mesh, ends, waits, self.readers, self.slot_senders)


@dataclasses.dataclass
class _Arrival:
    """A transfer's end: ``wait()`` orders each shard's stream after the
    transfer streams in ``waits[d]``, those that deliver rows to shard d
    and those that read rows of shard d (so shard d's next write of those
    rows comes after the read), and marks its receive buffers as used
    there. ``senders[slot]``: the shards whose events that transfer stream
    waited on."""

    mesh: ShardMesh
    ends: Dict[int, "torch.cuda.Event"]
    waits: Dict[int, List[int]]
    readers: List[Tuple[torch.Tensor, int, int]]
    senders: Dict[int, set]
    waited: bool = False

    def wait(self) -> None:
        if self.waited or not self.mesh.cuda:
            self.waited = True
            return
        for d, slots in self.waits.items():
            s = self.mesh.compute(d)
            for slot in slots:
                s.wait_event(self.ends[slot])
        for t, d, _ in self.readers:
            t.record_stream(self.mesh.compute(d))
        self.waited = True


def ring_perms(num_devices: int, axis: str = "shard"):
    """Forward (d -> d+1) and backward (d -> d-1) ring permutations."""
    fwd = [(d, (d + 1) % num_devices) for d in range(num_devices)]
    bwd = [(d, (d - 1) % num_devices) for d in range(num_devices)]
    return fwd, bwd


def transport_span(tracer, kind: str, *, impl: str, depth: int = 0, **attrs):
    """The one span every traced transport goes through (the reference's).

    Centralizing the category choice and the ``impl``/``depth`` tagging here
    keeps the attribution uniform across the three transport families (ring
    halo, stride/XOR partner, global gather), whichever runtime issues
    them: ``kind`` is the span name ("halo_exchange", "stride_exchange",
    "gather_global", ...); a kind containing "gather" lands in the
    ``gather`` category, every other in ``exchange``. A null or absent
    tracer records nothing."""
    if tracer is None or not tracer.enabled:
        return contextlib.nullcontext()
    category = "gather" if "gather" in kind else "exchange"
    return tracer.span(kind, category, impl=impl, depth=depth, **attrs)


def _started(start: Callable, mesh: ShardMesh, tracer, kind: str,
             span: Optional[dict], **attrs):
    """``start()``, a transport's start, inside ``transport_span``
    (``span``'s attributes added, its "name" entry, if any, in place of
    ``kind``), giving its handle; with a tracer the start is synchronous:
    the handle joined and the mesh drained before the span closes."""
    extra = dict(span or {})
    with transport_span(tracer, extra.pop("name", kind), **attrs, **extra):
        handle = start()
        if tracer is not None and tracer.enabled:
            handle.join()
            mesh.drain()
    return handle


def _mesh_of(mesh, what: str) -> ShardMesh:
    if not isinstance(mesh, ShardMesh):
        raise ValueError(
            f"{what} across shards takes the D shards and their ShardMesh; got "
            f"{type(mesh).__name__} (one tensor is the one-device case)")
    return mesh


def _one_device(num_devices) -> None:
    if num_devices != 1:
        raise ValueError(
            f"num_devices={num_devices} with one tensor: pass the D shards "
            f"and their ShardMesh")


# ------------------------------------------------------------------ halos


@dataclasses.dataclass
class HaloHandle:
    """An in-flight ring exchange: shard d's ``recv_left[d]`` and
    ``recv_right[d]`` receive buffers. Nothing may read them before
    ``join()``, which orders each receiving shard after the transfer; what
    a shard issues between start and join runs under it."""

    recv_left: List[torch.Tensor]
    recv_right: List[torch.Tensor]
    arrival: Optional[_Arrival] = None

    def join(self) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        if self.arrival is not None:
            self.arrival.wait()
        return self.recv_left, self.recv_right


def _slice(x: torch.Tensor, start: int, n: int, row_axis: int) -> torch.Tensor:
    return x.narrow(row_axis, start, n)


def _gather_edges_start(mesh: ShardMesh, firsts: Shards, lasts: Shards, *,
                        row_axis: int = 0, out=None) -> HaloHandle:
    """"xla": both directions in one packed ring buffer per receiving
    device, [first_0 | last_0 | first_1 | last_1 | ...], one
    concatenation; shard d's left halo is shard d-1's ``last`` and its
    right halo shard d+1's ``first``, views of the ring (copied into
    ``out``'s buffers, where given)."""
    D = mesh.size
    r = firsts[0].shape[row_axis]
    heads, tails = out if out is not None else ([None] * D, [None] * D)
    tx = mesh.sent(range(D))
    packed = [t for pair in zip(firsts, lasts) for t in pair]
    rings = {dev: tx.gather(packed, dev, row_axis) for dev in mesh.distinct}
    left, right = [], []
    for d in range(D):
        ring = rings[mesh.devices[d]]
        left.append(tx.read_by(_slice(ring, ((d - 1) % D) * 2 * r + r, r, row_axis), d,
                               heads[d]))
        right.append(tx.read_by(_slice(ring, ((d + 1) % D) * 2 * r, r, row_axis), d,
                                tails[d]))
    return HaloHandle(left, right, tx.done())


def _ppermute_edges_start(mesh: ShardMesh, firsts: Shards, lasts: Shards, *,
                          row_axis: int = 0, out=None) -> HaloHandle:
    """"ppermute": one copy per direction per shard: shard d-1's ``last``
    rows into shard d's left buffer, shard d+1's ``first`` into its right
    (``out``'s buffers, where given)."""
    del row_axis  # whole buffers move; the slicing already happened
    D = mesh.size
    heads, tails = out if out is not None else ([None] * D, [None] * D)
    fwd, bwd = ring_perms(D)
    tx = mesh.sent(range(D))
    left: List[Optional[torch.Tensor]] = [None] * D
    right: List[Optional[torch.Tensor]] = [None] * D
    for s, d in fwd:
        left[d] = tx.move(lasts[s], d, s, heads[d])   # from d-1: its last r
    for s, d in bwd:
        right[d] = tx.move(firsts[s], d, s, tails[d])  # from d+1: its first r
    return HaloHandle(left, right, tx.done())


#: name -> edge-transfer starter ``start(mesh, firsts, lasts, *, row_axis,
#: out)``
HALO_ASYNC_IMPLS: Dict[str, Callable[..., HaloHandle]] = {
    "xla": _gather_edges_start,
    "ppermute": _ppermute_edges_start,
}


def exchange_edges_start(mesh: ShardMesh, firsts: Shards, lasts: Shards, *,
                         row_axis: int = 0, impl: str = "xla", out=None, tracer=None,
                         span: Optional[dict] = None) -> HaloHandle:
    """Start a ring exchange of pre-sliced edge rows: ``firsts[d]`` and
    ``lasts[d]`` are shard d's leading and trailing r rows along
    ``row_axis`` (e.g. a pipelined launch's boundary outputs, the rows the
    next launch's neighbours need). ``out=(heads, tails)``: shard d's rows
    land in ``heads[d]`` and ``tails[d]``. Join with
    ``exchange_halos_join``."""
    _mesh_of(mesh, "exchange_edges_start")
    try:
        start = HALO_ASYNC_IMPLS[impl]
    except KeyError:
        raise ValueError(
            f"unknown halo async impl {impl!r}; known {sorted(HALO_ASYNC_IMPLS)}"
        ) from None
    return _started(lambda: start(mesh, firsts, lasts, row_axis=row_axis, out=out), mesh,
                    tracer, "halo_exchange", span, impl=impl,
                    depth=firsts[0].shape[row_axis])


def exchange_halos_start(mesh: ShardMesh, locals_: Shards, r: int, *,
                         row_axis: int = 0, impl: str = "xla", out=None, tracer=None,
                         span: Optional[dict] = None) -> HaloHandle:
    """Start a ring exchange of r rows each way for every shard; join for
    the results (in ``out=(heads, tails)``, where given). Past a block
    (r > B) the whole chain of block shifts: hop h brings the block h
    shards away, the blocks line up in global order, and the innermost r
    rows are kept; hops past the ring revisit blocks, the periodic (mod W)
    semantics the combines expect."""
    _mesh_of(mesh, "exchange_halos_start")
    n = locals_[0].shape[row_axis]
    if r <= n:
        return exchange_edges_start(
            mesh, [_slice(x, 0, r, row_axis) for x in locals_],
            [_slice(x, n - r, r, row_axis) for x in locals_],
            row_axis=row_axis, impl=impl, out=out, tracer=tracer, span=span)
    D = mesh.size
    hops = -(-r // n)  # ceil: whole-block shifts per direction

    def start():
        tx = mesh.sent(range(D))
        blocks = []
        for d in range(D):
            # global row order: [d-hops .. d-1] on the left, [d+1 .. d+hops] right
            blocks.append(([tx.move(locals_[(d - h) % D], d, (d - h) % D)
                            for h in range(hops, 0, -1)],
                           [tx.move(locals_[(d + h) % D], d, (d + h) % D)
                            for h in range(1, hops + 1)]))
        return _ChainHandle([], [], tx.done(), blocks, r, hops * n, row_axis, mesh, out)

    return _started(start, mesh, tracer, "halo_exchange", span, impl="ppermute", depth=r,
                    hops=hops)


@dataclasses.dataclass
class _ChainHandle(HaloHandle):
    """A multi-hop exchange: the received blocks, lined up into the r rows
    each side by each shard once the transfer has arrived."""

    blocks: list = dataclasses.field(default_factory=list)
    r: int = 0
    total: int = 0
    row_axis: int = 0
    mesh: Optional[ShardMesh] = None
    out: Optional[tuple] = None

    def join(self) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        if self.arrival is not None:
            self.arrival.wait()
        if not self.recv_left:
            for d, (lb, rb) in enumerate(self.blocks):
                with self.mesh.on(d):
                    left = _slice(torch.cat(lb, dim=self.row_axis),
                                  self.total - self.r, self.r, self.row_axis)
                    right = _slice(torch.cat(rb, dim=self.row_axis), 0, self.r, self.row_axis)
                    if self.out is not None:
                        left = self.out[0][d].copy_(left)
                        right = self.out[1][d].copy_(right)
                self.recv_left.append(left)
                self.recv_right.append(right)
        return self.recv_left, self.recv_right


def exchange_halos_join(handle: HaloHandle) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Complete an exchange: (recv_left, recv_right) per shard, now safe to
    read."""
    return handle.join()


def exchange_halos(local, r: int, mesh=1, *, row_axis: int = 0, out=None, tracer=None,
                   span: Optional[dict] = None):
    """The r rows that sit immediately left and right of each block in
    global order, wrapped at the ends (the combine masks the wrap off for
    non-periodic patterns).

    One tensor (``mesh`` 1): the one-device ring wrap, the block's last r
    rows and its first r, as views; past the block (r > B), the rows
    (-r .. -1) and (B .. B + r - 1) mod B. A sequence of D shards with
    their `ShardMesh`: the synchronous spelling, start and join back to
    back on the "ppermute" transport (the reference pins it there for the
    rungs and the serial schedule), returning per-shard lists (``out``'s
    buffers, where given); ``tracer`` and ``span`` as for the starts."""
    if isinstance(local, torch.Tensor):
        _one_device(mesh)
        B = local.shape[row_axis]
        if r <= B:
            return _slice(local, B - r, r, row_axis), _slice(local, 0, r, row_axis)
        rows = torch.arange(-r, B + r, device=local.device) % B
        return (local.index_select(row_axis, rows[:r]),
                local.index_select(row_axis, rows[B + r:]))
    return exchange_halos_join(
        exchange_halos_start(mesh, local, r, row_axis=row_axis, impl="ppermute", out=out,
                             tracer=tracer, span=span))


# ---------------------------------------------------------------- strides
#
# Butterfly patterns (fft/tree) pair point p with p XOR 2^k: at block
# strides, shard d's partner rows live wholesale on shard d XOR bs (bs =
# stride // block). The XOR permutation is an involution, so one copy per
# requested stride both sends and receives a full partner block.


@dataclasses.dataclass
class StrideHandle:
    """In-flight XOR block exchange: ``partners[j][d]`` is the block of
    shard ``d XOR block_strides[j]`` in a receive buffer of shard d. The
    same start/join discipline as `HaloHandle`."""

    partners: Tuple[List[torch.Tensor], ...]
    arrival: Optional[_Arrival] = None

    def join(self) -> Tuple[List[torch.Tensor], ...]:
        if self.arrival is not None:
            self.arrival.wait()
        return self.partners


def _gather_stride_start(mesh: ShardMesh, locals_: Shards, block_strides, *,
                         row_axis: int = 0) -> StrideHandle:
    """"xla": every shard's block gathered once per receiving device, one
    concatenation whatever the number of strides; each partner block a view
    of that ring."""
    D = mesh.size
    n = locals_[0].shape[row_axis]
    tx = mesh.sent(range(D))
    rings = {dev: tx.gather(locals_, dev, row_axis) for dev in mesh.distinct}
    return StrideHandle(tuple(
        [tx.read_by(_slice(rings[mesh.devices[d]], (d ^ bs) * n, n, row_axis), d)
         for d in range(D)] for bs in block_strides), tx.done())


def _ppermute_stride_start(mesh: ShardMesh, locals_: Shards, block_strides, *,
                           row_axis: int = 0) -> StrideHandle:
    """"ppermute": one copy of the partner block per stride per shard (the
    least traffic)."""
    del row_axis  # whole blocks move
    D = mesh.size
    tx = mesh.sent(range(D))
    return StrideHandle(tuple(
        [tx.move(locals_[d ^ bs], d, d ^ bs) for d in range(D)] for bs in block_strides),
        tx.done())


#: name -> stride-transfer starter ``start(mesh, locals_, block_strides, *,
#: row_axis)``, mirroring HALO_ASYNC_IMPLS
STRIDE_ASYNC_IMPLS: Dict[str, Callable[..., StrideHandle]] = {
    "xla": _gather_stride_start,
    "ppermute": _ppermute_stride_start,
}


def exchange_stride_start(mesh: ShardMesh, locals_: Shards, block_strides, *,
                          row_axis: int = 0, impl: str = "xla", tracer=None,
                          span: Optional[dict] = None) -> StrideHandle:
    """Start an XOR block exchange for each stride in ``block_strides``.

    The device count must be a power of two (d XOR bs is a permutation of
    the ring only then; elsewhere some partners fall off the mesh), and
    every stride in [1, D) (in-block pairing distances are local shuffles,
    not exchanges): both are refused loudly."""
    num_devices = mesh.size if isinstance(mesh, ShardMesh) else int(mesh)
    if num_devices & (num_devices - 1):
        raise ValueError(
            f"XOR stride exchange needs a power-of-two device count, "
            f"got {num_devices} (partner d XOR bs would leave the mesh)")
    for bs in block_strides:
        if not 0 < int(bs) < num_devices:
            raise ValueError(
                f"block stride {bs} outside [1, {num_devices}) — in-block "
                f"strides are local shuffles, not exchanges")
    _mesh_of(mesh, "exchange_stride_start")
    try:
        start = STRIDE_ASYNC_IMPLS[impl]
    except KeyError:
        raise ValueError(
            f"unknown stride async impl {impl!r}; "
            f"known {sorted(STRIDE_ASYNC_IMPLS)}") from None
    strides = tuple(int(b) for b in block_strides)
    return _started(lambda: start(mesh, locals_, strides, row_axis=row_axis), mesh, tracer,
                    "stride_exchange", span, impl=impl, strides=strides)


def exchange_stride_join(handle: StrideHandle) -> Tuple[List[torch.Tensor], ...]:
    """Complete a stride exchange: the partner blocks, safe to read."""
    return handle.join()


def exchange_stride(mesh: ShardMesh, locals_: Shards, block_strides, *,
                    row_axis: int = 0, impl: str = "xla", tracer=None,
                    span: Optional[dict] = None) -> Tuple[List[torch.Tensor], ...]:
    """Synchronous spelling: start and join back to back."""
    return exchange_stride_join(exchange_stride_start(
        mesh, locals_, block_strides, row_axis=row_axis, impl=impl, tracer=tracer,
        span=span))


# ---------------------------------------------------------------- gathers


@dataclasses.dataclass
class GatherHandle:
    """An in-flight all-gather: ``full[d]``, the global-order state in a
    receive buffer of shard d (shards on one device share one)."""

    full: List[torch.Tensor]
    arrival: Optional[_Arrival] = None

    def join(self) -> List[torch.Tensor]:
        if self.arrival is not None:
            self.arrival.wait()
        return self.full


def _gather_xla(mesh: ShardMesh, locals_: Shards, *, row_axis: int = 0) -> GatherHandle:
    """The shards concatenated once per receiving device: the monolithic
    all-gather."""
    tx = mesh.sent(range(mesh.size))
    rings = {dev: tx.gather(locals_, dev, row_axis) for dev in mesh.distinct}
    return GatherHandle([tx.read_by(rings[dev], d) for d, dev in enumerate(mesh.devices)],
                        tx.done())


def _gather_ppermute(mesh: ShardMesh, locals_: Shards, *, row_axis: int = 0) -> GatherHandle:
    """Per shard, the other D - 1 blocks copied in (the reference's D - 1
    whole-block ring shifts) and the ring assembled in global order."""
    D = mesh.size
    tx = mesh.sent(range(D))
    blocks = [[locals_[d] if j == d else tx.move(locals_[j], d, j) for j in range(D)]
              for d in range(D)]
    return _AssembledGather(blocks, tx.done(), mesh=mesh, row_axis=row_axis)


@dataclasses.dataclass
class _AssembledGather(GatherHandle):
    """A gather whose blocks each shard concatenates itself, on its own
    stream, after the transfer has arrived."""

    mesh: Optional[ShardMesh] = None
    row_axis: int = 0
    assembled: bool = False

    def join(self) -> List[torch.Tensor]:
        if self.arrival is not None:
            self.arrival.wait()
        if not self.assembled:
            out = []
            for d, blocks in enumerate(self.full):
                with self.mesh.on(d):
                    out.append(torch.cat(blocks, dim=self.row_axis))
            self.full, self.assembled = out, True
        return self.full


def gather_chunk_group(num_devices: int) -> int:
    """Segment size for the chunked gather: the divisor of D nearest
    sqrt(D), so both stages gather ~sqrt(D) parts. 1 or D degenerates to
    the monolithic gather."""
    best, best_err = 1, float("inf")
    for g in range(1, num_devices + 1):
        if num_devices % g:
            continue
        err = abs(g - num_devices ** 0.5)
        if err < best_err or (err == best_err and g > best):
            best, best_err = g, err
    return best


def _gather_chunked(mesh: ShardMesh, locals_: Shards, *, row_axis: int = 0,
                    group: Optional[int] = None) -> GatherHandle:
    """Hierarchical gather: segments of G contiguous shards gathered first
    (stage 1), then the segments (stage 2); exact row copies in global
    order, so the bits equal the monolithic gather's for every G | D.
    ``group=None`` leaves G to the scheduling policy
    (``schedule.choose_gather_chunk_group``: explicit > env > measured
    grouping probes > the sqrt(D) rule, `gather_chunk_group`); an explicit
    G must divide D, and G <= 1 or G >= D is the monolithic gather."""
    D = mesh.size
    if group is None:
        # imported here, as the reference does: this module stays importable
        # without the probes and their cache
        from repro_torch.kernels import schedule as _schedule

        group, _ = _schedule.choose_gather_chunk_group(
            devices=D, width=locals_[0].shape[row_axis] * D)
    g = int(group)
    if g >= 1 and D % g:
        raise ValueError(f"chunked gather group {g} does not divide D={D}")
    if g <= 1 or g >= D:
        return _gather_xla(mesh, locals_, row_axis=row_axis)
    tx = mesh.sent(range(D))
    full = {}
    for dev in mesh.distinct:
        segs = [tx.gather(locals_[b * g:(b + 1) * g], dev, row_axis) for b in range(D // g)]
        full[dev] = tx.gather(segs, dev, row_axis)
    return GatherHandle([tx.read_by(full[dev], d) for d, dev in enumerate(mesh.devices)],
                        tx.done())


#: name -> global-gather starter ``start(mesh, locals_, *, row_axis)``
GATHER_IMPLS: Dict[str, Callable[..., GatherHandle]] = {
    "xla": _gather_xla,
    "ppermute": _gather_ppermute,
    "chunked": _gather_chunked,
}

#: kind -> the registry behind it: the seam for transport extensions
TRANSPORT_REGISTRIES = {
    "halo": HALO_ASYNC_IMPLS,
    "stride": STRIDE_ASYNC_IMPLS,
    "gather": GATHER_IMPLS,
}


def register_transport_impl(kind: str, name: str, start, *, replace: bool = False) -> None:
    """Register a named transport starter in the ``kind`` registry, with
    the registry's signature. Shadowing a transport silently is refused
    unless ``replace=True``: a wrapper registered as "xla" by mistake would
    change every runtime in the process."""
    try:
        registry = TRANSPORT_REGISTRIES[kind]
    except KeyError:
        raise ValueError(
            f"unknown transport registry {kind!r}; "
            f"known {sorted(TRANSPORT_REGISTRIES)}") from None
    if name in registry and not replace:
        raise ValueError(
            f"transport impl {name!r} already registered for {kind!r}; "
            f"pass replace=True to shadow it deliberately")
    registry[name] = start


def gather_global_start(mesh: ShardMesh, locals_: Shards, *, row_axis: int = 0,
                        impl: str = "xla", chunk_group: Optional[int] = None, tracer=None,
                        span: Optional[dict] = None) -> GatherHandle:
    """Start an all-gather; join for each shard's global-order state."""
    _mesh_of(mesh, "gather_global")
    try:
        start = GATHER_IMPLS[impl]
    except KeyError:
        raise ValueError(
            f"unknown gather impl {impl!r}; known {sorted(GATHER_IMPLS)}") from None
    kw = {"group": chunk_group} if chunk_group is not None and impl == "chunked" else {}
    return _started(lambda: start(mesh, locals_, row_axis=row_axis, **kw), mesh, tracer,
                    "gather_global", span, impl=impl)


def gather_global(local, mesh=1, *, row_axis: int = 0, impl: str = "xla",
                  chunk_group: Optional[int] = None, tracer=None, span: Optional[dict] = None):
    """The full global-order state for every shard (the all-gather plan):
    one tensor on one device is the state itself; D shards with their
    `ShardMesh` give a list, shard d's in a receive buffer of shard d
    (``impl`` a GATHER_IMPLS name, every one the same bits)."""
    if isinstance(local, torch.Tensor):
        _one_device(mesh)
        return local
    return gather_global_start(mesh, local, row_axis=row_axis, impl=impl,
                               chunk_group=chunk_group, tracer=tracer, span=span).join()


def global_mean(local, width: int, mesh=1, *, row_axis: int = 0):
    """Mean over the global row axis (the uniform all_to_all combine): each
    block's row sum, the partial sums added across shards (the reference's
    psum: gathered once per device and summed there), over ``width``. One
    tensor: two device operations. D shards: a list, shard d's mean in a
    buffer of shard d. Within f32 reduction tolerance of the gathered
    masked mean, not bit for bit."""
    if isinstance(local, torch.Tensor):
        _one_device(mesh)
        return local.sum(dim=row_axis) / width
    _mesh_of(mesh, "global_mean")
    partial = []
    for d, x in enumerate(local):
        with mesh.on(d):
            partial.append(x.sum(dim=row_axis, keepdim=True))
    tx = mesh.sent(range(mesh.size))
    sums = {dev: tx.gather(partial, dev, row_axis) for dev in mesh.distinct}
    mine = [tx.read_by(sums[dev], d) for d, dev in enumerate(mesh.devices)]
    tx.done().wait()
    out = []
    for d, s in enumerate(mine):
        with mesh.on(d):
            out.append(s.sum(dim=row_axis) / width)
    return out
