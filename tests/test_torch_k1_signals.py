"""K1's rank form for ranks with a card each, on the CPU: the choice of route
from the ranks' placement (``parallel/mesh.py rank_form``: hosts and card
UUIDs; taken at window setup in ``_make_window``), a Python mirror of the signalled kernel's plan
(``signal_plan``, ``signal_grid``, ``next_targets``: which CTA stores and
copies which chunk, what it publishes into which counter, the targets the
host passes) and the signalled exchange's calls into the library through
``_exchange`` on stand-in entries, and the kernel variants that
``probe_k1_variants`` builds. The kernel itself runs only on the card
(``tests/test_torch_kernels.py``, ``chip_smoke.py``).

Tolerances: the plan's chunks are counted exactly; the mirror's exchange
is held bit for bit (a copy) to JAX's pallas_all_to_all in interpret mode
(``lp_gnn_tpu/parallel/pallas_halo.py:69``) and to the stacked plain
version. Inputs are made with numpy from a seed.
"""
import contextlib
import ctypes
import types

import numpy as np
import pytest
import torch

from lp_gnn_tpu_torch import probe_k1_variants as pkv
from lp_gnn_tpu_torch.ops import _build
from lp_gnn_tpu_torch.parallel import halo as thalo
from lp_gnn_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)

BENCH_BLOCK = 30_056 * 1024 * 2   # the bench graph's K1 block, D=1024 bf16
WAVE = 132 * 8                    # an H100's resident CTAs of 256 threads


def u64(addr):
    return ctypes.c_uint64.from_address(addr)


# ------------------------------------------------------------ the choice
def placement_of(hosts, cards) -> tmesh.Placement:
    """The placement of ranks on ``hosts`` (host keys) computing on
    ``cards`` (UUIDs; None off the card)."""
    return tmesh.Placement(tuple(hosts), tuple(tmesh.local_indices(hosts)),
                           tuple("cpu" if c is None else "cuda"
                                 for c in cards), tuple(cards),
                           tuple(0 if c is None else 8 for c in cards))


@pytest.mark.parametrize("hosts, cards, ranks, form", [
    ("hhhh", ["a", "b", "c", "d"], [0, 1, 2, 3], thalo.SIGNALLED),  # own
    ("hh", ["a", "b"], [0, 1], thalo.SIGNALLED),
    ("hhhh", ["a", "a", "a", "a"], [0, 1, 2, 3], thalo.FLAGS),  # one card
    ("hhhh", ["a", "b", "a", "c"], [0, 1, 2, 3], thalo.FLAGS),  # two share
    ("hhhh", ["a", "b", "a", "b"], [0, 1], thalo.FLAGS),  # the world shares
    ("hh", [None, None], [0, 1], thalo.FLAGS),            # without a card
    ("hhgg", ["a", "b", "a", "b"], [0, 1], thalo.SIGNALLED),  # a host a row
    ("hhgg", ["a", "b", "a", "b"], [0, 1, 2, 3], thalo.COLLECTIVE),
])
def test_rank_form_from_card_uuids(hosts, cards, ranks, form):
    """The route of a group from the world's placement: COLLECTIVE where
    its ranks span hosts; on one host the signalled form only where no
    rank of the world shares its (host, card UUID) with another, the flags
    form where any card is time-shared or a rank has none."""
    assert tmesh.rank_form(placement_of(hosts, cards), ranks) == form


class StubLib:
    """The C entries that ``_make_window`` calls, on the host: the
    allocation and the status word host memory, every call recorded."""

    def __init__(self):
        self.keep, self.calls = [], []

    def __call__(self, name):
        def fn(*a):
            self.calls.append(name)
            if name == "lp_halo_ipc_handle_bytes":
                return 64
            if name == "lp_halo_window_alloc":
                buf = (ctypes.c_char * a[0])()
                self.keep.append(buf)
                a[1]._obj.value = ctypes.addressof(buf)
            elif name == "lp_halo_status_alloc":
                word = ctypes.c_uint64(0)
                self.keep.append(word)
                a[0]._obj.value = a[1]._obj.value = ctypes.addressof(word)
            elif name == "lp_halo_flags_register":
                a[2]._obj.value = a[0]
            elif name == "lp_halo_window_open":
                a[1]._obj.value = 1 << 30
            return 0
        return fn


@pytest.mark.parametrize("hosts, cards, form", [
    ("hh", ["a", "b"], thalo.SIGNALLED), ("hh", ["a", "a"], thalo.FLAGS),
    ("hhhh", ["a", "b", "a", "b"], thalo.FLAGS),
    ("hg", ["a", "a"], thalo.COLLECTIVE)])
def test_make_window_takes_the_form_of_the_layout(monkeypatch, hosts, cards,
                                                  form):
    """``_make_window`` as rank 0 of a group of ranks 0 and 1 on cuda:0
    (the entries and the group's collectives stubbed): it takes the route
    the placement gives the group, and the allocation holds two windows
    and the counters; a group over two hosts makes nothing and raises."""
    lib = StubLib()
    header = types.SimpleNamespace(shm=types.SimpleNamespace(
        name="h0", unlink=lambda: None), register=lambda: 0, dev=8,
        host=16, close=lambda: None)

    def gather(out, obj, group=None):
        if isinstance(obj, tuple):
            out[:] = [obj, (0, obj[1], "h1")]
        else:
            out[:] = [obj, obj]

    monkeypatch.setattr(thalo, "_rank_lib", lib)
    monkeypatch.setattr(thalo, "_group_shape", lambda group: (2, 0))
    monkeypatch.setattr(tmesh, "group_ranks", lambda group: [0, 1])
    monkeypatch.setattr(tmesh, "_PLACEMENT", [placement_of(hosts, cards)])
    monkeypatch.setattr(thalo, "_Header", lambda name=None: header)
    monkeypatch.setattr(thalo.dist, "all_gather_object", gather)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    if form == thalo.COLLECTIVE:
        with pytest.raises(RuntimeError, match="makes no window"):
            thalo._make_window(4096, None, torch.device("cuda", 0))
        assert lib.calls == [] and tmesh.ROUTES[(0, 1)] == form
        return
    win = thalo._make_window(4096, None, torch.device("cuda", 0))
    assert win.form == form and tmesh.ROUTES[(0, 1)] == form
    assert len(lib.keep[0]) == 2 * 4096 + thalo.COUNTER_BYTES
    assert win.alloc_bytes == 2 * 4096 + thalo.COUNTER_BYTES
    assert [b for b in win.bases] == win.ptrs


# -------------------------------------------------------- the signal plan
BLOCKS = [16, thalo.CHUNK_BYTES - 16, thalo.CHUNK_BYTES + 16,
          30_056 * 8 * 2, BENCH_BLOCK]


@pytest.mark.parametrize("block_bytes", BLOCKS)
@pytest.mark.parametrize("k", range(2, 9))
def test_signal_plan_counts_what_the_peers_send(k, block_bytes):
    """At K ranks and a block of ``block_bytes`` (one 16-byte piece up to
    the bench shape's), with a card a rank (a whole wave) and with K
    streams on one card (a K-th of it each): every CTA goes through the
    TPU kernel's steps (a store into (me + s) mod K at step s, then the
    copy-out of what step s - 1 brought, its own block after step 1, the
    last source's slot at the end); every chunk of every block is stored
    and copied once; the chunks a destination counts in its arrival
    counter from a source (the CTAs' adds) equal the chunks that source
    sends, which is what the host's targets step by; the same for the
    done counters."""
    chunks = thalo.rank_chunks(block_bytes)
    assert chunks == -(-block_bytes // 16 // 1024)
    for share in (1, k):
        grid = thalo.signal_grid(WAVE, share, chunks)
        assert 1 <= grid <= min(chunks, WAVE // share)
        arrivals = np.zeros((k, k), np.int64)   # [destination, source]
        dones = np.zeros((k, k), np.int64)      # [source, reader]
        for me in range(k):
            seen = {}
            for b, ops in enumerate(thalo.signal_plan(k, me, chunks, grid)):
                want = [] if b >= chunks else [
                    op for s in range(1, k) for op in (
                        ("store", (me + s) % k),
                        ("own",) if s == 1 else ("copy", (me - s + 1) % k))
                ] + [("copy", (me + 1) % k)]
                assert [op[:-1] for op in ops] == want
                for op in ops:
                    seen.setdefault(op[:-1], []).extend(op[-1])
                    if op[0] == "store":
                        arrivals[op[1], me] += len(op[-1])
                    elif op[0] == "copy":
                        dones[op[1], me] += len(op[-1])
            assert len(seen) == 2 * (k - 1) + 1
            assert all(sorted(c) == list(range(chunks))
                       for c in seen.values())
        off = ~np.eye(k, dtype=bool)
        assert (arrivals[off] == chunks).all() and \
            (arrivals[~off] == 0).all()
        assert (dones[off] == chunks).all() and (dones[~off] == 0).all()


def test_targets_grow_and_never_repeat():
    """The host's targets over a run of exchanges of changing sizes on two
    windows in turn: exchange e's done target is exchange e - 2's arrival
    target (0 at e = 1, 2), arrival exceeds done by its chunks, and each
    window's targets only grow, so no counter value is awaited twice."""
    rng = np.random.RandomState(5)
    sent, seen = [0, 0], {0: [], 1: []}
    last = {0: 0, 1: 0}
    for e in range(1, 41):
        w = e % 2
        block = int(rng.choice(BLOCKS))
        arrival, done = thalo.next_targets(sent, w, block)
        assert done == last[w]
        assert arrival - done == thalo.rank_chunks(block) >= 1
        assert not seen[w] or arrival > seen[w][-1]
        seen[w].append(arrival)
        last[w] = arrival
    assert len(set(seen[0])) == len(seen[0]) == 20


def simulate(exchanges: list, share: int, rng) -> list:
    """The signalled kernels of K ranks over a run of exchanges, in Python:
    ``exchanges`` a list of (K, K*Bh, F) arrays; each rank's stream runs
    its kernels in order, every CTA of a kernel resident, one operation of
    ``signal_plan`` at a time of a rank and CTA drawn by ``rng`` among
    those that may go on (a store once its destination's done counter
    reaches the done target, a copy-out once the source's arrival counter
    reaches the arrival target), over two windows a rank with counters.
    Asserts that some operation can always go on (no deadlock) and that
    each chunk a copy-out reads was written by that exchange (not yet
    overwritten by a later one). Returns each exchange's K results."""
    k = len(exchanges[0])
    raw = [np.ascontiguousarray(x).view(np.uint8).reshape(k, -1)
           for x in exchanges]
    size = max(r.shape[1] for r in raw) // k
    windows = np.zeros((k, 2, k * size), np.uint8)
    tags = np.zeros((k, 2, k, -(-size // thalo.CHUNK_BYTES)), np.int64)
    arrival = np.zeros((k, 2, k), np.int64)   # [rank, window, source]
    done = np.zeros((k, 2, k), np.int64)      # [rank, window, reader]
    sent, targets = [0, 0], []
    for e, r in enumerate(raw, 1):
        targets.append(thalo.next_targets(sent, e % 2, r.shape[1] // k))
    outs = [np.zeros_like(r) for r in raw]
    at = [0] * k                              # each rank's exchange
    kernels = [None] * k

    def launch(me):
        e = at[me]
        block = raw[e].shape[1] // k
        chunks = thalo.rank_chunks(block)
        grid = thalo.signal_grid(WAVE, share, chunks)
        kernels[me] = [list(ops) for ops in
                       thalo.signal_plan(k, me, chunks, grid)]

    def ready(me, op):
        e = at[me]
        w, (arr_t, done_t) = (e + 1) % 2, targets[e]
        if op[0] == "store":
            return done[me, w, op[1]] >= done_t
        if op[0] == "copy":
            return arrival[me, w, op[1]] >= arr_t
        return True

    def run(me, op):
        e = at[me]
        w, block = (e + 1) % 2, raw[e].shape[1] // k
        for c in op[-1]:
            a, b = c * thalo.CHUNK_BYTES, min((c + 1) * thalo.CHUNK_BYTES,
                                              block)
            if op[0] == "store":
                q = op[1]
                windows[q, w, me * size + a:me * size + b] = \
                    raw[e][me, q * block + a:q * block + b]
                tags[q, w, me, c] = e + 1
            elif op[0] == "copy":
                p = op[1]
                assert tags[me, w, p, c] == e + 1, "read an overwritten chunk"
                outs[e][me, p * block + a:p * block + b] = \
                    windows[me, w, p * size + a:p * size + b]
            else:
                outs[e][me, me * block + a:me * block + b] = \
                    raw[e][me, me * block + a:me * block + b]
        if op[0] == "store":
            arrival[op[1], w, me] += len(op[-1])
        elif op[0] == "copy":
            done[op[1], w, me] += len(op[-1])

    for me in range(k):
        launch(me)
    while any(a < len(raw) for a in at):
        can = [(me, b) for me in range(k) if at[me] < len(raw)
               for b, ops in enumerate(kernels[me])
               if ops and ready(me, ops[0])]
        assert can, f"deadlock: ranks at exchanges {at}"
        me, b = can[rng.randint(len(can))]
        run(me, kernels[me][b].pop(0))
        if not any(kernels[me]):
            at[me] += 1
            if at[me] < len(raw):
                launch(me)
    return [o.view(x.dtype).reshape(x.shape) for o, x in zip(outs, exchanges)]


@pytest.mark.parametrize("share", [1, "k"])
@pytest.mark.parametrize("k", [2, 3, 4, 8])
def test_signalled_exchanges_simulated_in_any_order(k, share):
    """Six exchanges of changing sizes (one 16-byte piece, one chunk, a
    ragged three) over K simulated ranks, their CTAs' operations run in a
    random order within what the counters allow: no deadlock, no chunk
    read after a later exchange overwrote it, each result bit for bit the
    stacked plain version's."""
    rng = np.random.RandomState(k)
    shapes = [(1, 4), (300, 32), (8, 512), (1, 4), (300, 32), (17, 24)]
    xs = [rng.randn(k, k * bh, f).astype(np.float32) for bh, f in shapes]
    got = simulate(xs, k if share == "k" else 1, rng)
    for x, g in zip(xs, got):
        np.testing.assert_array_equal(
            g, thalo.halo_all_to_all_plain(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("share", [1, 4])
def test_mirror_matches_jax_pallas_and_plain(share):
    """The signalled kernels' plan, simulated over 4 ranks' buffers of 3
    chunks a block (the last one ragged), against JAX's pallas_all_to_all
    in interpret mode under shard_map and against the stacked plain
    version: bit for bit."""
    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from lp_gnn_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from lp_gnn_tpu.parallel.pallas_halo import pallas_all_to_all
    k, bh, f = 4, 300, 32
    bufs = np.random.RandomState(21).randn(k, k * bh, f).astype(np.float32)
    assert thalo.rank_chunks(bh * f * 4) == 3
    mesh = jax_make_mesh({"edge": k}, devices=jax.devices()[:k])
    fn = jax.jit(shard_map(
        lambda a: pallas_all_to_all(a[0], "edge", k, bh)[None], mesh=mesh,
        in_specs=P("edge"), out_specs=P("edge"), check_vma=False))
    (got,) = simulate([bufs], share, np.random.RandomState(share))
    np.testing.assert_array_equal(got, np.asarray(fn(bufs)))
    np.testing.assert_array_equal(
        got, thalo.halo_all_to_all_plain(torch.from_numpy(bufs)).numpy())


# ------------------------------------------- the exchange's calls, stubbed
@pytest.fixture
def signalled_calls(monkeypatch):
    """``halo._exchange`` as rank 0 of 2 over a signalled window pair on
    stand-in entries that record each call and return its code (0, or
    ``codes[name]``); the pair's allocations at 1 MiB and 2 MiB, the
    headers two host arrays, the status word a host word, each window's
    event done. Returns (calls, status word, codes)."""
    calls, keep, codes = [], [], {}
    status = ctypes.c_uint64(0)

    def lib(name):
        def fn(*a):
            if name == "lp_halo_flags_write":
                calls.append((name, [a[0][i] for i in range(a[1])], a[2]))
            else:
                calls.append((name, a))
            return codes.get(name, 0)
        return fn

    def make(nbytes, group, dev):
        keep[:] = [(ctypes.c_uint64 * (thalo.HEADER_BYTES // 8))()
                   for _ in range(2)]
        return thalo._Window(0, nbytes, [1 << 20, 2 << 20], group,
                             [1 << 20, 2 << 20],
                             [ctypes.addressof(h) for h in keep],
                             ctypes.addressof(status),
                             ctypes.addressof(status), form=thalo.SIGNALLED,
                             counter_bytes=thalo.COUNTER_BYTES)

    def record(dev, win, w):
        win.events[w] = types.SimpleNamespace(query=lambda: True)

    monkeypatch.setattr(thalo, "_WINDOWS", {})
    monkeypatch.setattr(thalo, "_rank_lib", lib)
    monkeypatch.setattr(thalo, "launch_on", lambda dev, fn, *a: fn(*a, 0))
    monkeypatch.setattr(thalo, "_group_shape", lambda group: (2, 0))
    monkeypatch.setattr(thalo, "_make_window", make)
    monkeypatch.setattr(thalo, "_drop_window",
                        lambda key, failing=False: thalo._WINDOWS.pop(key))
    monkeypatch.setattr(thalo, "_record", record)
    monkeypatch.setattr(thalo.dist, "group",
                        types.SimpleNamespace(WORLD="world"))
    return calls, status, codes


def test_signalled_exchange_is_one_launch(signalled_calls):
    """Exchange e over a signalled pair is one counted launch of
    ``lp_halo_rank_signalled`` over window e mod 2 of both allocations,
    with this rank's abort words (its header's arrival words of that
    window), its status word and the counters' targets: done the chunks
    sent into the window before it, arrival those and its own. No flag
    wait or write, no launch of the flags form."""
    calls, _, _ = signalled_calls
    signalled = thalo.halo_rank_signalled.launches
    flags = thalo.halo_all_to_all_ranks.launches
    x = torch.zeros(2 * 500, 16)   # 2 chunks a block
    sent = [0, 0]
    for e in range(1, 6):
        del calls[:]
        out = thalo._exchange(x, None)
        win = thalo._WINDOWS[("world", None)]
        w = e % 2
        arrival, done = thalo.next_targets(sent, w, x.nbytes // 2)
        assert [c[0] for c in calls] == ["lp_halo_rank_signalled"]
        a = calls[0][1]
        assert a[0] == x.data_ptr() and a[1] == out.data_ptr()
        assert list(a[2]) == [1 << 20, 2 << 20]
        assert a[3:8] == (win.nbytes, w, 0, 2, x.nbytes // 2)
        assert a[8] == thalo._arrival(win.flags[0], w, 0)
        assert a[9] == win.status_dev
        assert a[10:13] == (arrival, done, 1)
        assert arrival - done == 2 and win.epoch == e
    assert thalo.halo_rank_signalled.launches == signalled + 5
    assert thalo.halo_all_to_all_ranks.launches == flags


def test_signalled_exchange_refused_or_aborted_raises(signalled_calls):
    """A launch the entry refuses aborts the exchange: the abort word into
    the peer's flag words on the stream, this rank's own by host stores,
    and a raise naming the error; the pair made anew after it. An abort
    word a kernel recorded in the status word makes the next exchange
    raise, naming the rank."""
    calls, status, codes = signalled_calls
    x = torch.zeros(2 * 8, 8)
    codes["lp_halo_rank_signalled"] = 1
    with pytest.raises(RuntimeError, match="rank 0's launch failed: CUDA "
                                           "error 1 \\(lp_halo_rank_"
                                           "signalled, exchange 1\\)"):
        thalo._exchange(x, None)
    word = thalo.ABORT | 1
    peer = 2 << 20
    assert calls[-1] == ("lp_halo_flags_write", [
        a for w in (0, 1) for a in (thalo._arrival(peer, w, 0),
                                    thalo._done(peer, w, 0))], word)
    win = thalo._WINDOWS[("world", None)]
    assert [u64(a).value for a in win.own_host] == [word] * 8
    del codes["lp_halo_rank_signalled"]
    thalo._exchange(x, None)
    assert thalo._WINDOWS[("world", None)].epoch == 1
    status.value = thalo.ABORT | 1 << 32 | 700
    with pytest.raises(RuntimeError, match="rank 1's launch failed: CUDA "
                                           "error 700"):
        thalo._exchange(x, None)


def test_stream_ranks_on_the_cpu_run_the_plain_version():
    """The one-process stand-in of K signalled ranks on the CPU: the
    stacked plain version, bit for bit; launches none."""
    bufs = torch.from_numpy(
        np.random.RandomState(3).randn(4, 4 * 6, 8).astype(np.float32))
    before = thalo.halo_rank_signalled.launches
    ranks = thalo.StreamRanks(torch.device("cpu"), 4, bufs[0].nbytes,
                              [None] * 4)
    got = ranks.exchange(list(bufs))
    want = thalo.halo_all_to_all_plain(bufs)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ranks.status() == 0
    assert thalo.halo_rank_signalled.launches == before



@pytest.mark.parametrize("name", sorted(pkv.VARIANTS))
def test_probe_variants_each_change_the_kernel(name):
    """``probe_k1_variants``' variants of the signalled kernel: each change
    applies to the source as it is, exactly once (the probe refuses a
    source it no longer fits), and gives another source, but ``kernel``,
    the source itself."""
    src = (_build.SRC_DIR / "halo_a2a.cu").read_text()
    got = pkv.variant_source(name, src)
    assert (got == src) == (name == "kernel")
    assert "halo_rank_signalled_kernel(const __grid_constant__ RankArgs a)" \
        in got
    for old, _ in pkv.VARIANTS[name]:
        with pytest.raises(ValueError, match="occurs 0 times"):
            pkv.variant_source(name, src.replace(old, ""))
