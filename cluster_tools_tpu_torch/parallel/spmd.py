"""SPMD bodies over a mesh: ``shard_map`` and its collectives.

The port's counterpart of ``cluster_tools_tpu/compat.py::shard_map`` and of
the ``jax.lax`` collectives the reference's ``parallel/`` bodies use.  A
body is written once, against the collectives below, and runs once per
shard:

- :func:`shard_map` splits the global tensors by their specs, runs the
  body on every shard with a :class:`ShardContext` current, and puts the
  outputs back together.  A spec is a :class:`P` of one mesh-axis name or
  ``None`` per leading dimension; ``P()`` is replicated, and a replicated
  output is checked to be equal on every shard (the reference's fence,
  ``tests/test_parallel.py:552``).
- :func:`axis_index`, :func:`ppermute` (zeros where nothing arrives, as
  ``lax.ppermute``), :func:`all_gather`, :func:`psum`, :func:`pmax` and
  :func:`all_to_all` (tiled) act on the current shard's context.

Two backends carry the collectives:

- **In one process**, each shard's body runs on its own thread and every
  collective is a rendezvous: all members of the group deposit their
  operand, the last to arrive computes every member's result in rank
  order (so results never depend on thread timing), and each takes its
  own.  A rendezvous has a deadline; when it passes, or when a member's
  body has already returned without reaching it, it raises naming the
  collective and the shards missing.  An exception in one shard aborts
  every rendezvous, so the other shards raise instead of hanging.  Each
  shard's thread runs under ``torch.cuda.device(its card)`` on that card's
  default stream, and nothing here sets another stream.  Shards on one
  card share that stream, so a tensor handed between threads after a
  rendezvous is ordered by launch order.  Across cards, the thread that
  computes the results moves each operand with ``.to(card)``: PyTorch's
  copy between two cards first makes the source card's current stream
  wait for the destination card's, and then makes the destination card's
  current stream wait for the copy.  So work a shard queued on its card
  before the rendezvous is done before the copy reads it, and work the
  receiving shard queues afterwards starts after the copy lands.  A copy
  between cards without peer access goes through host memory; it is
  ordered the same way.
- **Across processes** (:class:`ProcessComm`, built by
  :func:`~.multihost.pod_mesh`), each process runs its own shards as
  above; once a group's local members have deposited, the last of them
  carries the cross-process leg over a process group of its own:
  ``all_gather`` for gathers and sums, ``all_reduce(MAX)`` for ``pmax``,
  send/recv pairs for ``ppermute`` and ``all_to_all``.  Over gloo, CUDA
  tensors are staged through pinned host memory.  Over NCCL each process
  owns one card, and every process group's communicator is made when the
  group is (:meth:`ProcessComm.attach`), with every rank taking part, so a
  first send/recv batch that leaves a rank out cannot hang on it.

:data:`COUNTERS` counts collective calls and operand bytes by stage and
kind, the seconds shards spent waiting in rendezvous, and the bytes staged
through host memory.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

#: seconds a shard waits at a rendezvous before it raises
DEFAULT_DEADLINE_S = 600.0

_TLS = threading.local()


class CollectiveError(RuntimeError):
    """A collective could not complete (mismatch, missing shard, abort)."""


class CollectiveTimeout(CollectiveError, TimeoutError):
    """A rendezvous passed its deadline."""


class ReplicationError(RuntimeError):
    """An output promised replicated differs between shards."""


class P(tuple):
    """A partition spec: one mesh-axis name (or ``None``) per leading
    dimension; dimensions past the spec are not sharded.  ``P()`` is
    replicated."""

    def __new__(cls, *names):
        return super().__new__(cls, names)


class Counters:
    """Collective calls, operand bytes and rendezvous wait seconds, by
    stage (the ``name`` given to :func:`shard_map`) and kind."""

    FIELDS = ("calls", "bytes", "wait_s")

    def __init__(self):
        self._lock = threading.Lock()
        self._c: Dict[Tuple[str, str], Counter] = {}

    def add(self, stage: str, kind: str, **delta) -> None:
        with self._lock:
            c = self._c.setdefault((stage, kind), Counter())
            for k, v in delta.items():
                c[k] += v

    def reset(self) -> None:
        with self._lock:
            self._c.clear()

    def snapshot(self) -> Dict[str, Dict[str, Dict[str, float]]]:
        with self._lock:
            out: Dict[str, Dict[str, Dict[str, float]]] = {}
            for (stage, kind), c in sorted(self._c.items()):
                out.setdefault(stage, {})[kind] = {f: c.get(f, 0) for f in self.FIELDS}
            return out


COUNTERS = Counters()


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _group(mesh, shard: int, name: str):
    """``(key, member index, member shards)`` of ``shard``'s group along
    mesh axis ``name``: the shards that differ from it only there."""
    if name not in mesh.axis_names:
        raise KeyError(f"mesh has no axis {name!r} (axes {mesh.axis_names})")
    ai = mesh.axis_names.index(name)
    coords = list(mesh.coords(shard))
    members = []
    for i in range(mesh.grid[ai]):
        c = list(coords)
        c[ai] = i
        members.append(mesh.shard_at(c))
    key = (name, tuple(-1 if j == ai else c for j, c in enumerate(coords)))
    return key, coords[ai], members


def _check_operands(kind: str, ops: Sequence[torch.Tensor]) -> None:
    first = ops[0]
    for i, o in enumerate(ops[1:], 1):
        if o.shape != first.shape or o.dtype != first.dtype:
            raise CollectiveError(
                f"{kind}: member {i} gave {tuple(o.shape)}/{o.dtype}, member 0 {tuple(first.shape)}/{first.dtype}"
            )


def _per_device(fn, ops, devices):
    """One result for each distinct device, shared by its members."""
    cache: Dict[torch.device, torch.Tensor] = {}
    return [cache[d] if d in cache else cache.setdefault(d, fn(d)) for d in devices]


def _compute(kind: str, meta, ops: List[torch.Tensor], devices: List[torch.device]) -> List[torch.Tensor]:
    """Every member's result of a collective from all operands, in member
    order."""
    n = len(ops)
    _check_operands(kind, ops)
    if kind == "ppermute":
        out: List[Optional[torch.Tensor]] = [None] * n
        for s, d in meta:
            out[d] = ops[s].to(devices[d])
        return [o if o is not None else torch.zeros_like(ops[m]) for m, o in enumerate(out)]
    if kind == "all_gather":
        join = torch.cat if meta else torch.stack
        return _per_device(lambda d: join([o.to(d) for o in ops]), ops, devices)
    if kind in ("psum", "pmax"):
        def reduce(d):
            acc = ops[0].to(d)
            for o in ops[1:]:
                acc = acc + o.to(d) if kind == "psum" else torch.maximum(acc, o.to(d))
            return acc
        return _per_device(reduce, ops, devices)
    if kind == "all_to_all":
        split_axis, concat_axis = meta
        chunks = [torch.tensor_split(o, n, dim=split_axis) for o in ops]
        return [torch.cat([chunks[i][j].to(devices[j]) for i in range(n)], dim=concat_axis) for j in range(n)]
    raise ValueError(f"unknown collective {kind!r}")


class _Slot:
    __slots__ = ("kind", "meta", "ops", "results", "done", "taken")

    def __init__(self, kind, meta):
        self.kind, self.meta = kind, meta
        self.ops: Dict[int, torch.Tensor] = {}
        self.results = None
        self.done = False
        self.taken = 0


class _Runtime:
    """Rendezvous state of one :func:`shard_map` call."""

    def __init__(self, mesh, name: str, deadline_s: float):
        self.mesh = mesh
        self.name = name
        self.deadline_s = float(deadline_s)
        self.cond = threading.Condition()
        self.slots: Dict[tuple, _Slot] = {}
        self.error: Optional[Tuple[int, BaseException]] = None
        self.finished: set = set()
        self.local = set(mesh.local_shards())

    def fail(self, shard: int, exc: BaseException) -> None:
        with self.cond:
            if self.error is None:
                self.error = (shard, exc)
            self.cond.notify_all()

    def raise_if_failed(self, shard: int, what: str) -> None:
        if self.error is not None and self.error[0] != shard:
            src, exc = self.error
            raise CollectiveError(f"shard {shard}: {what} aborted: shard {src} raised {type(exc).__name__}: {exc}")


class ShardContext:
    """The current shard inside :func:`shard_map`: its coordinates and the
    collectives over the mesh's axes."""

    def __init__(self, rt: _Runtime, shard: int):
        self._rt = rt
        self.mesh = rt.mesh
        self.shard = shard
        self.coords = rt.mesh.coords(shard)
        self.device = rt.mesh.devices[shard]
        self._seq: Counter = Counter()

    def axis_index(self, name: str) -> int:
        return self.coords[self.mesh.axis_names.index(name)]

    def axis_size(self, name: str) -> int:
        return self.mesh.axis_size(name)

    def ppermute(self, x, name: str, perm) -> torch.Tensor:
        perm = tuple((int(s), int(d)) for s, d in perm)
        n = self.axis_size(name)
        if len({d for _, d in perm}) != len(perm) or any(not (0 <= v < n) for p in perm for v in p):
            raise ValueError(f"ppermute over {name!r} (size {n}): bad permutation {perm}")
        return self._collective("ppermute", name, x, perm)

    def all_gather(self, x, name: str, tiled: bool = False) -> torch.Tensor:
        return self._collective("all_gather", name, x, bool(tiled))

    def psum(self, x, name: str) -> torch.Tensor:
        return self._collective("psum", name, x, None)

    def pmax(self, x, name: str) -> torch.Tensor:
        return self._collective("pmax", name, x, None)

    def all_to_all(self, x, name: str, split_axis: int, concat_axis: int, tiled: bool = True) -> torch.Tensor:
        if not tiled:
            raise NotImplementedError("all_to_all is ported with tiled=True only (the reference's one use)")
        n = self.axis_size(name)
        if x.shape[split_axis] % n:
            raise ValueError(f"all_to_all over {name!r}: axis {split_axis} extent {x.shape[split_axis]} "
                             f"not divisible by {n}")
        return self._collective("all_to_all", name, x, (int(split_axis), int(concat_axis)))

    def _collective(self, kind: str, name: str, x, meta) -> torch.Tensor:
        rt = self._rt
        x = torch.as_tensor(x, device=self.device)
        key, member, members = _group(self.mesh, self.shard, name)
        seq = self._seq[key]
        self._seq[key] += 1
        COUNTERS.add(rt.name, kind, calls=int(member == 0), bytes=_nbytes(x))
        n = len(members)
        if n == 1:
            return _compute(kind, meta, [x], [self.device])[0]
        devices = [self.mesh.devices[s] for s in members]
        local_members = [m for m, s in enumerate(members) if s in rt.local]
        what = f"{kind} over axis {name!r} (call {seq} of group {key[1]})"
        slot_key = (key, seq)
        t0 = time.perf_counter()
        leader = False
        with rt.cond:
            rt.raise_if_failed(self.shard, what)
            slot = rt.slots.get(slot_key)
            if slot is None:
                slot = rt.slots[slot_key] = _Slot(kind, meta)
            elif (slot.kind, slot.meta) != (kind, meta):
                raise CollectiveError(f"shard {self.shard} reached {what} with {meta!r} where another member "
                                      f"reached {slot.kind} with {slot.meta!r}: shards must reach the same "
                                      "collectives in the same order")
            slot.ops[member] = x
            if len(slot.ops) == len(local_members):
                if len(local_members) == n:
                    slot.results = _compute(kind, meta, [slot.ops[m] for m in range(n)], devices)
                    slot.done = True
                    rt.cond.notify_all()
                else:
                    leader = True
            deadline = t0 + rt.deadline_s
            while not (slot.done or leader):
                rt.raise_if_failed(self.shard, what)
                missing = [members[m] for m in local_members if m not in slot.ops]
                gone = [s for s in missing if s in rt.finished]
                if gone:
                    raise CollectiveError(f"{what}: shard(s) {gone} returned without reaching it")
                left = deadline - time.perf_counter()
                if left <= 0:
                    raise CollectiveTimeout(f"{what}: shard(s) {missing} did not reach the rendezvous within "
                                            f"{rt.deadline_s:g} s")
                rt.cond.wait(left)
        if leader:
            results = self.mesh.comm.exchange(kind, meta, key, members, dict(slot.ops), devices)
            with rt.cond:
                slot.results = results
                slot.done = True
                rt.cond.notify_all()
        with rt.cond:
            result = slot.results[member]
            slot.taken += 1
            if slot.taken == len(local_members):
                del rt.slots[slot_key]
        COUNTERS.add(rt.name, kind, wait_s=time.perf_counter() - t0)
        return result


def context() -> ShardContext:
    """The current shard's context; raises outside :func:`shard_map`."""
    ctx = getattr(_TLS, "ctx", None)
    if ctx is None:
        raise RuntimeError("collectives run only inside a shard_map body")
    return ctx


def axis_index(name: str) -> int:
    return context().axis_index(name)


def ppermute(x, name: str, perm) -> torch.Tensor:
    return context().ppermute(x, name, perm)


def all_gather(x, name: str, tiled: bool = False) -> torch.Tensor:
    return context().all_gather(x, name, tiled)


def psum(x, name: str) -> torch.Tensor:
    return context().psum(x, name)


def pmax(x, name: str) -> torch.Tensor:
    return context().pmax(x, name)


def all_to_all(x, name: str, split_axis: int, concat_axis: int, tiled: bool = True) -> torch.Tensor:
    return context().all_to_all(x, name, split_axis, concat_axis, tiled)


# ---------------------------------------------------------------- specs ----


def _as_spec(spec) -> P:
    if isinstance(spec, P):
        return spec
    if isinstance(spec, str):
        return P(spec)
    if spec is None:
        return P()
    return P(*spec)


def _piece(x: torch.Tensor, spec: P, mesh, shard: int) -> torch.Tensor:
    coords = mesh.coords(shard)
    for d, name in enumerate(spec):
        if name is None:
            continue
        n = mesh.axis_size(name)
        ext = x.shape[d]
        if ext % n:
            raise ValueError(f"dimension {d} of extent {ext} does not divide over mesh axis {name!r} of size {n}")
        c = coords[mesh.axis_names.index(name)]
        x = x.narrow(d, c * (ext // n), ext // n)
    return x.to(mesh.devices[shard]).contiguous()


def _assemble(pieces: Dict[int, torch.Tensor], spec: P, mesh) -> torch.Tensor:
    """The global tensor from one piece per shard; along axes the spec does
    not name, the shard at coordinate 0 stands for the others."""
    named = [(d, name) for d, name in enumerate(spec) if name is not None]
    out_dev = mesh.devices[min(pieces)]

    def rec(k, coords):
        if k == len(named):
            return pieces[mesh.shard_at(coords)].to(out_dev)
        d, name = named[k]
        ai = mesh.axis_names.index(name)
        parts = []
        for i in range(mesh.grid[ai]):
            c = list(coords)
            c[ai] = i
            parts.append(rec(k + 1, c))
        return torch.cat(parts, dim=d)

    return rec(0, [0] * len(mesh.grid))


class Sharded:
    """A tensor split over a mesh by ``spec``: this process's pieces, by
    shard.  :func:`shard_map` takes one in place of a global tensor (its
    pieces go straight to their shards) and returns them for
    ``keep_sharded=True``; :meth:`full` assembles the global tensor."""

    def __init__(self, mesh, spec: P, pieces: Dict[int, torch.Tensor]):
        self.mesh = mesh
        self.spec = spec
        self.pieces = pieces

    def full(self) -> torch.Tensor:
        pieces = self.pieces
        if self.mesh.comm is not None:
            pieces = self.mesh.comm.gather_pieces(self.mesh, pieces)
        return _assemble(pieces, self.spec, self.mesh)


def shard(x, mesh, spec) -> Sharded:
    """``x`` split over ``mesh`` by ``spec``, once, for several
    :func:`shard_map` calls."""
    spec = _as_spec(spec)
    t = torch.as_tensor(x)
    return Sharded(mesh, spec, {s: _piece(t, spec, mesh, s) for s in mesh.local_shards()})


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
    return type(a) is type(b) and a == b


def shard_map(body, mesh, in_specs, out_specs, *, name: str = "shard_map", keep_sharded: bool = False):
    """Return ``f(*args)`` that runs ``body`` once per shard of ``mesh``.

    ``in_specs``: a spec (one argument) or a tuple of specs, one per
    argument; each argument is a global tensor (split here) or a
    :class:`Sharded` of the same spec.  ``out_specs``: a spec or a tuple of
    specs matching the body's output.  Sharded outputs come back as global
    tensors, or as :class:`Sharded` with ``keep_sharded=True``; replicated
    outputs (``P()``) are checked equal on every shard and returned once.
    ``name`` labels this call's collectives in :data:`COUNTERS`;
    :data:`DEFAULT_DEADLINE_S` bounds each rendezvous.
    """
    single_in = isinstance(in_specs, (P, str))
    ins = [_as_spec(in_specs)] if single_in else [_as_spec(s) for s in in_specs]
    single_out = isinstance(out_specs, (P, str))
    outs = [_as_spec(out_specs)] if single_out else [_as_spec(s) for s in out_specs]

    def call(*args):
        if len(args) != len(ins):
            raise TypeError(f"{name}: {len(args)} arguments for {len(ins)} in_specs")
        local = mesh.local_shards()
        shard_args = {s: [] for s in local}
        for a, spec in zip(args, ins):
            if isinstance(a, Sharded):
                if a.spec != spec or a.mesh is not mesh:
                    raise ValueError(f"{name}: a Sharded of spec {a.spec} passed for spec {spec}")
                for s in local:
                    shard_args[s].append(a.pieces[s])
            else:
                t = torch.as_tensor(a)
                for s in local:
                    shard_args[s].append(_piece(t, spec, mesh, s))
        rt = _Runtime(mesh, name, DEFAULT_DEADLINE_S)
        results: Dict[int, Any] = {}

        def run(shard):
            if getattr(_TLS, "ctx", None) is not None:
                raise RuntimeError("shard_map bodies do not nest")
            _TLS.ctx = ShardContext(rt, shard)
            dev = mesh.devices[shard]
            try:
                with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                    results[shard] = body(*shard_args[shard])
            # recorded for the caller, which raises the first shard's error
            # (a DrainInterrupt too) once every shard has stopped; other
            # shards abort at their next rendezvous
            except BaseException as exc:  # ctlint: disable=CT006
                rt.fail(shard, exc)
            finally:
                _TLS.ctx = None
                with rt.cond:
                    rt.finished.add(shard)
                    rt.cond.notify_all()

        if len(local) == 1 and mesh.comm is None:
            run(local[0])
        else:
            threads = [threading.Thread(target=run, args=(s,), name=f"{name}-shard{s}", daemon=True)
                       for s in local]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        if rt.error is not None:
            raise rt.error[1]
        return _outputs(results, local)

    def _outputs(results, local):
        per_shard = {s: (results[s],) if single_out else tuple(results[s]) for s in local}
        for s in local:
            if len(per_shard[s]) != len(outs):
                raise TypeError(f"{name}: body returned {len(per_shard[s])} outputs for {len(outs)} out_specs")
        final = []
        for i, spec in enumerate(outs):
            if len(spec) == 0:
                ref = per_shard[local[0]][i]
                for s in local[1:]:
                    if not _same(per_shard[s][i], ref):
                        raise ReplicationError(f"{name}: replicated output {i} differs between shards "
                                               f"{local[0]} and {s}")
                if mesh.comm is not None:
                    mesh.comm.check_replicated(ref, f"{name}: replicated output {i}")
                final.append(ref)
            else:
                sh = Sharded(mesh, spec, {s: per_shard[s][i] for s in local})
                final.append(sh if keep_sharded else sh.full())
        return final[0] if single_out else tuple(final)

    return call


# ------------------------------------------------------- across processes ----


class ProcessComm:
    """The cross-process leg of the collectives, over ``torch.distributed``.

    Each group of a mesh axis that spans processes gets a process group of
    its own (made in the same order in every process), so the legs of
    different groups never interleave on one channel.  Over gloo, CUDA
    tensors travel through pinned host memory (counted as ``host_staged``
    bytes); over NCCL they stay on the card.
    """

    def __init__(self, backend: str, rank: int, world_size: int):
        self.backend = backend
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.groups: Dict[tuple, Any] = {}
        self.mesh = None

    def attach(self, mesh) -> None:
        """Make the process groups of ``mesh``'s cross-process groups.

        Every process makes them in the same order.  Over NCCL, each new
        group then runs one ``all_reduce`` of its members: NCCL makes a
        communicator on the first operation of a group, and that needs
        every rank of the group, which a later ``ppermute`` whose edge
        ranks neither send nor receive would not give it."""
        import torch.distributed as dist

        self.mesh = mesh
        for name in mesh.axis_names:
            for s in range(mesh.size):
                key, _, members = _group(mesh, s, name)
                procs = sorted({mesh.processes[m] for m in members})
                if len(procs) > 1 and key not in self.groups:
                    group = dist.new_group(procs)
                    self.groups[key] = (group, procs)
                    if self.backend == "nccl" and self.rank in procs:
                        dev = mesh.devices[mesh.local_shards()[0]]
                        with torch.cuda.device(dev):
                            dist.all_reduce(torch.zeros(1, device=dev), group=group)

    # -- staging --
    def _wire(self, x: torch.Tensor, stage: str = "") -> torch.Tensor:
        x = x.contiguous()
        if x.dtype == torch.bool:
            x = x.to(torch.uint8)
        if self.backend == "gloo" and x.is_cuda:
            h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            h.copy_(x)
            COUNTERS.add(stage or "comm", "host_staged", bytes=_nbytes(h))
            return h
        return x

    def _wire_empty(self, like: torch.Tensor) -> torch.Tensor:
        """A receive buffer for ``like``'s shape, in its wire form."""
        dtype = torch.uint8 if like.dtype == torch.bool else like.dtype
        if self.backend == "gloo" and like.is_cuda:
            return torch.empty(like.shape, dtype=dtype, pin_memory=True)
        return torch.empty(like.shape, dtype=dtype, device=like.device)

    @staticmethod
    def _unwire(x: torch.Tensor, like: torch.Tensor, device) -> torch.Tensor:
        return x.to(device=device, dtype=like.dtype)

    def _p2p(self, sends, recvs, group) -> None:
        import torch.distributed as dist

        ops = [dist.P2POp(dist.isend, t, peer, group, tag) for t, peer, tag in sends]
        ops += [dist.P2POp(dist.irecv, t, peer, group, tag) for t, peer, tag in recvs]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()

    def exchange(self, kind: str, meta, key, members, local_ops: Dict[int, torch.Tensor], devices):
        """Results for this process's members of one collective, given
        their operands; the other processes' members arrive here."""
        import torch.distributed as dist

        group, procs = self.groups[key]
        n = len(members)
        proc_of = [self.mesh.processes[s] for s in members]
        like = next(iter(local_ops.values()))
        mine = sorted(local_ops)
        if kind in ("all_gather", "psum"):
            by_proc = {p: [m for m in range(n) if proc_of[m] == p] for p in procs}
            if len({len(v) for v in by_proc.values()}) != 1:
                raise CollectiveError(f"{kind}: processes hold unequal shares of group {key}")
            stacked = self._wire(torch.stack([local_ops[m] for m in mine]), kind)
            bufs = [torch.empty_like(stacked) for _ in procs]
            dist.all_gather(bufs, stacked, group=group)
            full: List[Optional[torch.Tensor]] = [None] * n
            for p, buf in zip(procs, bufs):
                for k, m in enumerate(by_proc[p]):
                    full[m] = self._unwire(buf[k], like, devices[m])
            res = _compute(kind, meta, full, devices)
            return {m: res[m] for m in mine}
        if kind == "pmax":
            acc = local_ops[mine[0]]
            for m in mine[1:]:
                acc = torch.maximum(acc, local_ops[m].to(acc.device))
            w = self._wire(acc, kind)
            dist.all_reduce(w, op=dist.ReduceOp.MAX, group=group)
            return {m: self._unwire(w, like, devices[m]) for m in mine}
        if kind == "ppermute":
            out: Dict[int, torch.Tensor] = {}
            sends, recvs, bufs = [], [], {}
            for s, d in meta:
                if proc_of[s] == self.rank and proc_of[d] == self.rank:
                    out[d] = local_ops[s].to(devices[d])
                elif proc_of[s] == self.rank:
                    sends.append((self._wire(local_ops[s], kind), proc_of[d], s * n + d))
                elif proc_of[d] == self.rank:
                    bufs[d] = self._wire_empty(local_ops[d])
                    recvs.append((bufs[d], proc_of[s], s * n + d))
            self._p2p(sends, recvs, group)
            for d, b in bufs.items():
                out[d] = self._unwire(b, like, devices[d])
            return {m: out[m] if m in out else torch.zeros_like(local_ops[m]) for m in mine}
        if kind == "all_to_all":
            split_axis, concat_axis = meta
            chunks = {m: torch.tensor_split(local_ops[m], n, dim=split_axis) for m in mine}
            got: Dict[Tuple[int, int], torch.Tensor] = {}
            sends, recvs, bufs = [], [], {}
            for i in range(n):
                for j in mine:
                    if proc_of[i] == self.rank:
                        got[(i, j)] = chunks[i][j].to(devices[j])
                    else:
                        bufs[(i, j)] = self._wire_empty(chunks[j][i])
                        recvs.append((bufs[(i, j)], proc_of[i], i * n + j))
            for i in mine:
                for j in range(n):
                    if proc_of[j] != self.rank:
                        sends.append((self._wire(chunks[i][j], kind), proc_of[j], i * n + j))
            self._p2p(sends, recvs, group)
            for (i, j), b in bufs.items():
                got[(i, j)] = self._unwire(b, like, devices[j])
            return {j: torch.cat([got[(i, j)] for i in range(n)], dim=concat_axis) for j in mine}
        raise ValueError(f"unknown collective {kind!r}")

    def _all_gather_world(self, x: torch.Tensor, stage: str) -> List[torch.Tensor]:
        import torch.distributed as dist

        w = self._wire(x, stage)
        bufs = [torch.empty_like(w) for _ in range(self.world_size)]
        dist.all_gather(bufs, w)
        return bufs

    def gather_pieces(self, mesh, pieces: Dict[int, torch.Tensor]) -> Dict[int, torch.Tensor]:
        """Every shard's piece, in every process (called by every process in
        the same order, outside shard bodies)."""
        local = sorted(pieces)
        like = pieces[local[0]]
        bufs = self._all_gather_world(torch.stack([pieces[s] for s in local]), "assemble")
        out = {}
        for p, buf in enumerate(bufs):
            shards = [s for s in range(mesh.size) if mesh.processes[s] == p]
            if len(shards) != buf.shape[0]:
                raise CollectiveError(f"process {p} holds {len(shards)} shards but sent {buf.shape[0]} pieces")
            for k, s in enumerate(shards):
                out[s] = self._unwire(buf[k], like, like.device)
        return out

    def check_replicated(self, value, what: str) -> None:
        """Raise unless ``value`` is the same in every process."""
        t = torch.as_tensor(value)
        bufs = self._all_gather_world(t.reshape(-1) if t.dim() == 0 else t, "fence")
        ref = bufs[0]
        for p, b in enumerate(bufs[1:], 1):
            if not torch.equal(b, ref):
                raise ReplicationError(f"{what} differs between processes 0 and {p}")

