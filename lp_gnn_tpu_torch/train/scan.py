"""Several training steps in one dispatch (counterpart of
``lp_gnn_tpu/train/trainer.py:114 make_scan_train_step``, the trainer's
``--steps_per_call K``).

The JAX package runs K sequential steps under ``lax.scan`` inside one jit
dispatch: exactly K calls of the single step, in the same order, with one
host round trip for the K losses. The port's counterpart on the card is a
CUDA graph of the K steps:

- The first visit of a stack (the same graph tensors, in the same order)
  runs its K steps eagerly, on the step's own capture stream: a real
  training step each, which also makes the kernels' workspaces and
  cuBLAS's on that stream, where the capture will look for them. Then it
  captures the K steps into one ``torch.cuda.CUDAGraph`` (capture
  executes nothing); every later visit replays the graph. The graphs of
  one step object share one memory pool.
- The graphs read the graph tensors, the parameters, the optimizer's state
  and its learning rate in place: none of these may be rebuilt while the
  step lives. Adam must be built with ``capturable=True`` (its step counts
  and a tensor learning rate on the card, ``trainer.make_optimizer``); an
  optimizer whose learning rate is a Python float (SGD) has it fixed in a
  graph, so graphs are captured anew for each learning rate.
- The dropout generator is registered with each graph, so that a replay
  draws fresh masks and leaves the generator where K eager steps would.
- A graph cannot branch on a host value, so a captured step copies its
  logits out, and after the replay the decode accuracy is computed from
  them for the steps that ask for it, -1 for the others, as JAX's
  ``lax.cond`` computes it only where asked (trainer.py:154-156).
- Nothing falls back: a capture or a replay that fails raises.

On the CPU the step is the plain loop of ``trainer.train_step`` with no
host read in between.

The wrappers' launch counters tick where a wrapper is called: at capture,
where no kernel runs, and not at replay. :data:`CAPTURED` holds the
wrapper calls that were recorded into graphs, :data:`REPLAYED` the kernel
launches that replays made (each graph's recorded calls times its
replays); the launches on the card are a wrapper's count less its
``CAPTURED`` plus its ``REPLAYED`` (:func:`card_launches`).
"""
from __future__ import annotations

import torch

from ..ops.gather import gather_rows
from ..ops.gen_agg import gen_agg_bwd, gen_agg_fwd, gen_lse_merge
from ..ops.spmm import spmm_csr
from ..parallel.halo import halo_all_to_all
from ..utils.profiling import annotate
from .losses import LOSS_REGISTRY

COUNTED = (spmm_csr, gather_rows, halo_all_to_all, gen_agg_fwd, gen_agg_bwd,
           gen_lse_merge)
CAPTURED: dict[str, int] = {}   # wrapper calls recorded into graphs
REPLAYED: dict[str, int] = {}   # kernel launches made by replays


def reset_counts() -> None:
    CAPTURED.clear()
    REPLAYED.clear()


def card_launches(name: str, counted: int) -> int:
    """The launches of wrapper ``name`` on the card, from its counter
    ``counted``: less the calls that capture recorded, plus those that
    replays ran."""
    return counted - CAPTURED.get(name, 0) + REPLAYED.get(name, 0)


def _counts() -> dict[str, int]:
    return {k.__name__: k.launches for k in COUNTED}


class _Stack:
    """One stack's state on the card: its graph tensors (held, so that
    they outlive the graph that reads them), its graph, the kernel calls
    it recorded and its output buffers (the K losses, each step's
    logits)."""

    def __init__(self, graphs):
        self.graphs = graphs
        self.graph = None
        self.nodes: dict[str, int] = {}
        self.losses = None
        self.logits: list = []


class ScanTrainStep:
    """``step(graphs_or_graph, lr=None, acc_on=None, k=None) -> (losses
    (K,), accs (K,))``: K steps that update the model and the optimizer in
    place (module docstring). ``stacked=True`` takes a sequence of K graph
    tensors, one a step; ``stacked=False`` one graph for all ``k`` steps.
    ``lr`` (if given) is set on the optimizer first (``trainer.set_lr``).
    ``acc_on`` (K bools; None: all) selects the steps whose decode accuracy
    is returned, -1.0 elsewhere. Both outputs are fp32 tensors on the
    graphs' device: reading them is the caller's synchronization."""

    def __init__(self, model, loss_name: str, optimizer, stacked: bool = True,
                 generator: torch.Generator | None = None):
        self.model, self.optimizer = model, optimizer
        self.loss_fn = LOSS_REGISTRY[loss_name]
        self.stacked = stacked
        self.generator = generator
        self.stacks: dict = {}
        self.pool = None
        self.stream = None
        self.captures = self.replays = 0

    def __call__(self, graphs, lr: float | None = None, acc_on=None,
                 k: int | None = None):
        if self.stacked:
            graphs = list(graphs)
        else:
            if k is None:
                raise ValueError("stacked=False needs k, the number of steps")
            graphs = [graphs] * k
        acc_on = [True] * len(graphs) if acc_on is None else \
            [bool(a) for a in acc_on]
        if len(acc_on) != len(graphs) or not graphs:
            raise ValueError(f"{len(graphs)} steps, {len(acc_on)} acc_on")
        from . import trainer   # the trainer imports this module
        if lr is not None:
            trainer.set_lr(self.optimizer, lr)
        device = graphs[0].device
        if device.type != "cuda":
            return self._eager(graphs, acc_on)
        return self._on_card(graphs, acc_on, device)

    def _eager(self, graphs, acc_on):
        """K ``trainer.train_step`` calls, no host read in between."""
        from . import trainer
        losses, accs = [], []
        for gt, want in zip(graphs, acc_on):
            loss, acc = trainer.train_step(self.model, self.optimizer, gt,
                                           self.loss_fn, self.generator, want)
            losses.append(loss.float())
            accs.append(acc.float() if acc is not None else
                        torch.full((), -1.0, device=loss.device))
        return torch.stack(losses), torch.stack(accs)

    def _lr_key(self):
        """None where every group's learning rate is a tensor read in place
        by the graphs; else the learning rates, fixed in a graph."""
        lrs = [g["lr"] for g in self.optimizer.param_groups]
        if all(torch.is_tensor(v) for v in lrs):
            return None
        return tuple(float(v) for v in lrs)

    def _on_card(self, graphs, acc_on, device):
        lr_key = self._lr_key()
        key = (tuple(id(g) for g in graphs), lr_key)
        if self.stream is None:
            self.stream = torch.cuda.Stream(device)
        if lr_key is not None:
            # graphs of another learning rate are never replayed again
            for old in [k for k in self.stacks if k[1] != lr_key]:
                del self.stacks[old]
        caller = torch.cuda.current_stream(device)
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            st = self.stacks.get(key)
            if st is None:
                # the first visit: eager, on the capture stream, then the
                # capture, which executes nothing
                st = _Stack(graphs)
                with annotate("scan_eager"):
                    losses, accs = self._eager(graphs, acc_on)
                self._capture(st, device)
                self.stacks[key] = st
            else:
                with annotate("scan_replay"):
                    st.graph.replay()
                self.replays += 1
                for name, n in st.nodes.items():
                    REPLAYED[name] = REPLAYED.get(name, 0) + n
                losses, accs = st.losses.clone(), self._accs(st, acc_on)
        caller.wait_stream(self.stream)
        losses.record_stream(caller)
        accs.record_stream(caller)
        return losses, accs

    def _accs(self, st: _Stack, acc_on):
        """The decode accuracy from each replayed step's logits where
        asked (``trainer.step_accuracy``), -1.0 elsewhere."""
        from . import trainer
        accs = []
        for gt, (lc, lv), want in zip(st.graphs, st.logits, acc_on):
            if want:
                ms, mt = trainer.seed_masks(gt)
                accs.append(trainer.step_accuracy(gt, lc, lv, ms, mt).float())
            else:
                accs.append(torch.full((), -1.0, device=lc.device))
        return torch.stack(accs)

    def _capture(self, st: _Stack, device) -> None:
        """Capture the stack's K steps into one graph of the shared pool;
        the losses and each step's logits land in buffers made outside it.
        Every block the graph takes from the pool is written before it is
        read within one replay, and what outlives a replay (parameters,
        optimizer state, the output buffers, the generator's state) lies
        outside the pool: so the stacks may be replayed in any order (the
        trainer's permutation changes every epoch), although another
        graph's capture may reuse this one's temporaries."""
        from . import trainer
        st.losses = torch.empty(len(st.graphs), device=device)
        st.logits = [(torch.empty(gt.ncons, 3, device=device),
                      torch.empty(gt.nvars, 3, device=device))
                     for gt in st.graphs]
        graph = torch.cuda.CUDAGraph()
        gen = self.generator
        if gen is not None and gen.device.type == "cuda":
            graph.register_generator_state(gen)
        before = _counts()
        with annotate("scan_capture"), \
                torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            for i, gt in enumerate(st.graphs):
                loss, _ = trainer.train_step(self.model, self.optimizer, gt,
                                             self.loss_fn, gen,
                                             logits_out=st.logits[i])
                st.losses[i].copy_(loss)
        after = _counts()
        st.nodes = {n: after[n] - before[n] for n in after
                    if after[n] != before[n]}
        for name, n in st.nodes.items():
            CAPTURED[name] = CAPTURED.get(name, 0) + n
        st.graph = graph
        if self.pool is None:
            self.pool = graph.pool()
        self.captures += 1


def make_scan_train_step(model, loss_name: str, optimizer,
                         stacked: bool = True,
                         generator: torch.Generator | None = None
                         ) -> ScanTrainStep:
    """K sequential training steps in one call (trainer.py:114): exactly
    K ``train_step`` calls, in order, one graph a step (``stacked=True``,
    the trainer's ``--steps_per_call`` path) or one graph K times
    (``stacked=False``, bench.py's repeated-step measurement); on the card
    one CUDA graph a stack after its first visit (:class:`ScanTrainStep`)."""
    return ScanTrainStep(model, loss_name, optimizer, stacked, generator)
