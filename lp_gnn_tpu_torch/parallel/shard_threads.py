"""One thread a shard: the runtime of an edge mesh with one shard a device
in one process (``mesh.EdgeMesh``, the layout of the JAX package's
``--mesh_shape edge=K`` over K devices, ``parallel/mesh.py:72
make_mesh``).

Each shard's forward is the rank path's one-shard forward, the model code
unchanged, run in a thread of its own (as ``torch.nn.parallel
.parallel_apply`` runs replicas) on its device and on a CUDA stream of its
own, also where the devices repeat (the CPU tests, one card). The
collectives of the forward meet at a rendezvous (:meth:`ShardThreads.meet`):
the last shard to arrive applies one autograd node over all K shards'
tensors (:class:`Joint`) and hands each its output. A step's one
``backward()`` from the caller's thread then runs every collective's
backward once, over all K shards, without waiting for any thread: autograd
runs all of one device's backward nodes on one worker thread, so a
barrier inside a backward node would hang as soon as two shards share a
card.

The parameters have one master copy, on the lead device (shard 0's).
:func:`replicas` gives each shard a shallow copy of the model whose
parameters are the outputs of one :class:`Broadcast` node, so that each
shard reads them on its device and the backward sums the K gradients on
the lead, in shard order. On a grid of devices (``mesh.DeviceGrid``) one
:class:`Broadcast` a step covers all D*E cells and each row's forwards
read their cells' replicas from it: one node sums the D*E gradients on the
lead in (d, e) order, so a step does not depend on the order in which the
devices' backward threads finish.

The shards' threads take turns: one runs from a collective to the next
while the others wait on a lock, so the interpreter is not handed between
threads at every torch op (each op lets the others in); the kernels they
queue still run on every device at once.

Grad mode, inference mode, the current device and the current stream are
thread-local: :meth:`ShardThreads.run` sets them in each thread. An
exception in one shard's thread aborts the rendezvous: the shards waiting
there raise :class:`ShardAborted` at once, and the caller gets the first
error that was not such an abort. A shard that waits at a collective for
more than ``MEET_S`` seconds (a peer stuck outside the collectives) raises
too, so no thread is left waiting.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time

import torch

# the longest a shard waits at a collective for the others to arrive
MEET_S = 300.0


class ShardAborted(RuntimeError):
    """A shard left a collective because another shard failed."""


@dataclasses.dataclass(frozen=True)
class Member:
    """Shard ``rank`` of ``threads``: the ``group`` of that shard's
    one-shard edge mesh (``mesh.EdgeMesh``) inside its thread."""
    threads: "ShardThreads"
    rank: int

    @property
    def size(self) -> int:
        return self.threads.size

    def meet(self, tag, value, fn):
        return self.threads.meet(self.rank, tag, value, fn)


class ShardThreads:
    """The K shards of an edge mesh with one shard a device, ``devices[k]``
    holding shard k: their CUDA streams (one a shard, made at first use; on
    the CPU none), the rendezvous of their collectives and the thread
    runner."""

    def __init__(self, devices, streams_of=None):
        self.devices = tuple(torch.device(d) for d in devices)
        self.size = len(self.devices)
        self._streams = None
        # where the streams come from when another group owns them
        # (:meth:`part`)
        self._streams_of = streams_of
        self._cv = threading.Condition()
        # the turn: of the shards' threads only its holder runs, from one
        # collective to the next (``run``, ``meet``)
        self._turn = threading.Lock()
        self._local = threading.local()
        self._reset()

    def __repr__(self) -> str:
        return f"ShardThreads({[str(d) for d in self.devices]})"

    def _reset(self) -> None:
        self._arrived: dict[int, tuple] = {}
        self._round = 0
        self._result = None
        self._failed: BaseException | None = None
        self._finished = 0

    @property
    def cuda(self) -> bool:
        return self.devices[0].type == "cuda"

    @property
    def streams(self) -> list:
        """One CUDA stream a shard, on its device (None each on the CPU)."""
        if self._streams is None:
            self._streams = self._streams_of() if self._streams_of else [
                torch.cuda.Stream(device=d) if d.type == "cuda" else None
                for d in self.devices]
        return self._streams

    def member(self, k: int) -> Member:
        return Member(self, k)

    def part(self, ks) -> "ShardThreads":
        """The threads of shards ``ks`` alone (a row or a column of a device
        grid, ``mesh.DeviceGrid``): a group of its own, with its own
        rendezvous and turn, whose shard i runs on shard ``ks[i]``'s device
        and stream, so that a tensor recorded on a stream here is recorded
        on the stream that reads it there."""
        ks = list(ks)
        return ShardThreads([self.devices[k] for k in ks],
                            lambda: [self.streams[k] for k in ks])

    @contextlib.contextmanager
    def on(self, k: int):
        """Shard k's device and stream current (nothing on the CPU)."""
        if self.devices[k].type != "cuda":
            yield
            return
        with torch.cuda.device(self.devices[k]), \
                torch.cuda.stream(self.streams[k]):
            yield

    def each(self, fn) -> list:
        """``[fn(k) for every shard k]``, each on shard k's device and
        stream."""
        out = []
        for k in range(self.size):
            with self.on(k):
                out.append(fn(k))
        return out

    # ------------------------------------------------------ stream order
    def _by_device(self) -> dict:
        """device -> the shard streams on it."""
        out: dict = {}
        for d, s in zip(self.devices, self.streams):
            out.setdefault(d, []).append(s)
        return out

    def current_streams(self) -> dict:
        """Each CUDA device's current stream in the calling thread."""
        if not self.cuda:
            return {}
        return {d: torch.cuda.current_stream(d) for d in self._by_device()}

    def enter(self, ready: dict | None = None) -> None:
        """Before work on the shard streams of a joint node's backward: each
        shard stream waits for its device's current stream in the calling
        thread, its default stream and ``ready[device]`` (where the node's
        forward left its outputs, the streams autograd accumulates their
        gradients on)."""
        if not self.cuda:
            return
        for d, shard_streams in self._by_device().items():
            waits = {torch.cuda.current_stream(d), torch.cuda.default_stream(d)}
            if ready and d in ready:
                waits.add(ready[d])
            for s in shard_streams:
                for w in waits:
                    if w != s:
                        s.wait_stream(w)

    def leave(self) -> None:
        """After work on the shard streams: each device's current stream in
        the calling thread and its default stream wait for every shard
        stream on it (autograd takes a node's results as ready there)."""
        if not self.cuda:
            return
        for d, shard_streams in self._by_device().items():
            for w in {torch.cuda.current_stream(d), torch.cuda.default_stream(d)}:
                for s in shard_streams:
                    if w != s:
                        w.wait_stream(s)

    def move(self, x: torch.Tensor, src: int, dst: int) -> torch.Tensor:
        """``x``, made on shard ``src``'s stream, as shard ``dst`` reads it
        on its own stream: on the same device ``x`` itself (dst's stream
        waits for src's, and ``x`` is recorded on it), else a copy on dst's
        device (the copy orders the two streams itself)."""
        dev = self.devices[dst]
        if x.device.type != "cuda":
            return x.to(dev)
        s, d = self.streams[src], self.streams[dst]
        if x.device == dev:
            if s != d:
                d.wait_stream(s)
                x.record_stream(d)
            return x
        with torch.cuda.stream(s), torch.cuda.stream(d):
            return x.to(dev)

    # -------------------------------------------------------- rendezvous
    def meet(self, k: int, tag, value, fn):
        """Shard k's part of one collective: every shard hands in its
        ``value``; the last to arrive calls ``fn(values)`` (the K values in
        shard order; it returns K results) and every shard returns its own
        result. ``tag`` names the collective: shards that meet at different
        ones raise. Raises :class:`ShardAborted` where another shard failed,
        and after ``MEET_S`` seconds without the others. A shard that waits
        hands the turn on while it waits and takes it back after."""
        with self._cv:
            self._check_failed()
            rnd = self._round
            self._arrived[k] = (tag, value)
            if self._finished:
                err = RuntimeError(f"shard {k} reached a collective ({tag!r}) "
                                   "that a shard which ended never will")
                self._fail(err)
                raise err
            last = len(self._arrived) == self.size
            if last:
                arrived = [self._arrived[i] for i in range(self.size)]
                self._arrived = {}
        if not last:
            held = self._hand_on()
            try:
                return self._await(k, tag, rnd)
            finally:
                if held:
                    self._take_turn()
        tags = {t for t, _ in arrived}
        try:
            if len(tags) > 1:
                raise RuntimeError(f"the shards met at different collectives: "
                                   f"{[t for t, _ in arrived]}")
            out = fn([v for _, v in arrived])
        except BaseException as e:
            self.abort(e)
            raise
        with self._cv:
            self._result = out
            self._round += 1
            self._cv.notify_all()
        return out[k]

    def _await(self, k: int, tag, rnd: int):
        """Shard k's wait at the collective of round ``rnd`` until the last
        shard applied it: its result, or the error that ended it."""
        with self._cv:
            deadline = time.monotonic() + MEET_S
            while self._round == rnd and self._failed is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    err = RuntimeError(
                        f"shard {k} waited {MEET_S} s at a collective "
                        f"({tag!r}) for shards "
                        f"{sorted(set(range(self.size)) - set(self._arrived))}")
                    self._fail(err)
                    raise err
                self._cv.wait(left)
            if self._round == rnd:
                self._check_failed()
            return self._result[k]

    # -------------------------------------------------------------- turn
    # Python runs one thread at a time, and every torch op lets the others
    # take the interpreter: K threads that all run would hand it on at
    # each op. So a shard runs only while it holds the turn, which it
    # hands on only where it waits at a collective or ends.
    def _take_turn(self) -> None:
        self._turn.acquire()
        self._local.turn = True

    def _hand_on(self) -> bool:
        """Give the turn up where this thread holds it; whether it did."""
        if not getattr(self._local, "turn", False):
            return False
        self._local.turn = False
        self._turn.release()
        return True

    def _check_failed(self) -> None:
        if self._failed is not None:
            raise ShardAborted(f"another shard failed: {self._failed!r}")

    def _fail(self, err: BaseException) -> None:
        if self._failed is None:
            self._failed = err
        self._cv.notify_all()

    def abort(self, err: BaseException) -> None:
        """Release every shard waiting at a collective: each raises
        :class:`ShardAborted` (as does every later arrival)."""
        with self._cv:
            self._fail(err)

    def _finish(self) -> None:
        """A shard's thread ends: shards still waiting at a collective that
        it will never reach fail."""
        with self._cv:
            self._finished += 1
            if self._arrived and self._failed is None:
                self._fail(RuntimeError(
                    "a shard finished while shards "
                    f"{sorted(self._arrived)} wait at a collective "
                    f"({next(iter(self._arrived.values()))[0]!r})"))

    # ------------------------------------------------------------ runner
    def run(self, fn) -> list:
        """``[fn(k) for every shard k]``, one thread a shard, each with the
        caller's grad and inference modes and on shard k's device and
        stream, one at a time (the turn, from one collective to the next:
        the kernels they queue still run on all the devices at once); each
        shard stream first waits for the caller's current stream on its
        device, and the caller's current streams wait for every shard
        stream before this returns. The first error of a shard (not an
        abort it caused) is raised here once every thread ended."""
        grad = torch.is_grad_enabled()
        inference = torch.is_inference_mode_enabled()
        with self._cv:
            self._reset()
        if self.cuda:
            for d, s in zip(self.devices, self.streams):
                s.wait_stream(torch.cuda.current_stream(d))
        results: list = [None] * self.size
        errors: list = [None] * self.size

        def work(k):
            self._take_turn()
            try:
                with torch.inference_mode(inference), \
                        torch.set_grad_enabled(grad), self.on(k):
                    results[k] = fn(k)
            except BaseException as e:   # every error reaches the caller
                errors[k] = e
                self.abort(e)
            finally:
                self._finish()
                self._hand_on()

        threads = [threading.Thread(target=work, args=(k,), daemon=True,
                                    name=f"edge-shard-{k}")
                   for k in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if self.cuda:
            for d, shard_streams in self._by_device().items():
                cur = torch.cuda.current_stream(d)
                for s in shard_streams:
                    cur.wait_stream(s)
        failed = [e for e in errors if e is not None]
        if failed:
            raise next((e for e in failed if not isinstance(e, ShardAborted)),
                       failed[0])
        return results


def numbered_afresh(fn):
    """``fn()`` run in a thread of its own and waited for, with the
    caller's grad and inference modes and its current device and streams;
    its error is raised here. The autograd engine takes the nodes that are
    ready in the order of their sequence numbers, which each thread counts
    on its own from 0: the shards' threads start from 0 at every run, the
    calling thread from wherever the process has brought it, and where the
    two ranges interleave the engine adds a tensor's gradients in another
    order. A step whose forward and loss run here sums its gradients in
    one order whatever the process ran before it (its first step too)."""
    grad = torch.is_grad_enabled()
    inference = torch.is_inference_mode_enabled()
    streams = [torch.cuda.current_stream(i)
               for i in range(torch.cuda.device_count())] \
        if torch.cuda.is_initialized() else []
    device = torch.cuda.current_device() if streams else None
    out: list = []
    err: list = []

    def work():
        try:
            with contextlib.ExitStack() as stack:
                for s in streams:
                    stack.enter_context(torch.cuda.stream(s))
                if device is not None:
                    stack.enter_context(torch.cuda.device(device))
                stack.enter_context(torch.inference_mode(inference))
                stack.enter_context(torch.set_grad_enabled(grad))
                out.append(fn())
        except BaseException as e:   # every error reaches the caller
            err.append(e)

    t = threading.Thread(target=work, daemon=True, name="step-forward")
    t.start()
    t.join()
    if err:
        raise err[0]
    return out[0]


class Joint(torch.autograd.Function):
    """``Joint.apply(op, threads, metas, n_in, *flat)``: one collective of
    the K shards as one autograd node. ``flat`` holds each shard's
    ``n_in`` input tensors, shard after shard; ``metas[k]`` is what
    shard k's part needs besides (its partition tensors). ``op.forward(
    threads, metas, ins)`` returns the K outputs and, for each shard, the
    tensors its backward reads; ``op.backward(threads, metas, saved,
    grads, needs)`` returns, for each shard, the gradients of its inputs.
    Both run every shard's part on its stream (``threads.each``); the
    backward is bracketed by ``threads.enter`` / ``threads.leave``."""

    @staticmethod
    def forward(ctx, op, threads, metas, n_in, *flat):
        k = threads.size
        ins = [flat[i * n_in:(i + 1) * n_in] for i in range(k)]
        outs, saved = op.forward(threads, metas, ins)
        ctx.op, ctx.threads, ctx.metas, ctx.n_in = op, threads, metas, n_in
        ctx.n_saved = len(saved[0]) if saved else 0
        ctx.save_for_backward(*(t for per in saved for t in per))
        ctx.ready = threads.current_streams()
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        threads, n_in, m = ctx.threads, ctx.n_in, ctx.n_saved
        flat = ctx.saved_tensors
        saved = [flat[i * m:(i + 1) * m] for i in range(threads.size)]
        needs = [ctx.needs_input_grad[4 + i * n_in:4 + (i + 1) * n_in]
                 for i in range(threads.size)]
        threads.enter(ctx.ready)
        gin = ctx.op.backward(threads, ctx.metas, saved, list(grads), needs)
        threads.leave()
        return (None, None, None, None, *(g for per in gin for g in per))


def joint(op, member: Member, tag, tensors: tuple, meta):
    """Shard ``member.rank``'s side of one collective over the shards of
    ``member.threads``: its ``tensors`` and ``meta`` meet the other
    shards'; the last applies :class:`Joint` over all K and each gets its
    output."""
    threads = member.threads

    def apply(values):
        metas = [m for _, m in values]
        flat = [t for ts, _ in values for t in ts]
        out = Joint.apply(op, threads, metas, len(tensors), *flat)
        return (out,) if isinstance(out, torch.Tensor) else out

    return member.meet(tag, (tensors, meta), apply)


class Broadcast(torch.autograd.Function):
    """``Broadcast.apply(threads, *params)`` -> K copies of every
    parameter, shard after shard, each on its shard's device: the
    parameters of the shards' replicas. The backward sums each
    parameter's K gradients on the parameter's device (the lead), in shard
    order, each add rounded to the gradient's dtype."""

    @staticmethod
    def forward(ctx, threads, *params):
        ctx.threads, ctx.n = threads, len(params)
        ctx.devices = [p.device for p in params]
        out = []
        for k, d in enumerate(threads.devices):
            for p in params:
                c = p.detach().to(d, copy=True)
                if d.type == "cuda":
                    c.record_stream(threads.streams[k])
                out.append(c)
        ctx.ready = threads.current_streams()
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        threads, n = ctx.threads, ctx.n
        for d, s in ctx.ready.items():
            cur = torch.cuda.current_stream(d)
            for w in {s, torch.cuda.default_stream(d)}:
                if w != cur:
                    cur.wait_stream(w)
        out = []
        for i in range(n):
            acc = None
            for k in range(threads.size):
                g = grads[k * n + i].to(ctx.devices[i])
                if acc is None:
                    acc = g
                elif k == 1:
                    acc = acc + g
                else:
                    acc += g
            out.append(acc)
        return (None, *out)


def replicas(model: torch.nn.Module, threads: ShardThreads) -> list:
    """One shallow copy of ``model`` a shard, whose parameters are the
    shard's outputs of one :class:`Broadcast` of the model's (and whose
    buffers are copies on the shard's device): the model's own forward,
    run on shard k's tensors, reads them."""
    params = list(model.parameters())
    flat = Broadcast.apply(threads, *params) if params else ()
    n = len(params)
    out = []
    for k, dev in enumerate(threads.devices):
        by_id = {id(p): flat[k * n + i] for i, p in enumerate(params)}
        out.append(_replica(model, by_id, dev, {}))
    return out


def _replica(module, by_id: dict, dev: torch.device, memo: dict):
    if id(module) in memo:
        return memo[id(module)]
    rep = module._replicate_for_data_parallel()
    memo[id(module)] = rep
    for name, p in module._parameters.items():
        setattr(rep, name, None if p is None else by_id[id(p)])
    rep._buffers = {name: None if b is None else b.to(dev)
                    for name, b in module._buffers.items()}
    for name, sub in module._modules.items():
        rep._modules[name] = None if sub is None else \
            _replica(sub, by_id, dev, memo)
    return rep
