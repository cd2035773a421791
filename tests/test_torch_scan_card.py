"""The K-step training call (lp_gnn_tpu_torch/train/scan.py) on the card:
captured CUDA graphs against the same steps run eagerly, bit for bit, and
a capture that cannot be made raising. Each test needs an NVIDIA GPU
(``cuda`` marker) and skips without one.

This file imports neither JAX nor the JAX package, so it runs on the
machine with the card::

    python -m pytest --noconftest tests/test_torch_scan_card.py -q -m cuda
"""
import numpy as np
import pytest
import torch

from lp_gnn_tpu_torch.data.dataset import BipartiteGraph
from lp_gnn_tpu_torch.models.gcn import build_model
from lp_gnn_tpu_torch.train import scan as tscan
from lp_gnn_tpu_torch.train import trainer as ttrainer
from lp_gnn_tpu_torch.train.losses import LOSS_REGISTRY

torch.set_num_threads(2)

GCN = "GCN_FC(8,8,hids=64,depth=3,dtype='bfloat16')"          # dropout 0.1
GEN = "GENDeeper(8,8,hids=32,depth=4,dtype='bfloat16',remat=True)"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs run only on the card")
    return torch.device("cuda")


def lp_graph(seed, m, n, e):
    """A random bipartite LP graph with 3-class labels, sorted by row."""
    rng = np.random.RandomState(seed)
    row = rng.randint(0, m, e).astype(np.int32)
    col = rng.randint(0, n, e).astype(np.int32)
    c_feas = (rng.rand(m, 8) - 0.5).astype(np.float32)
    v_feas = (rng.rand(n, 8) - 0.5).astype(np.float32)
    for fe in (c_feas, v_feas):
        fe[:, -3] = rng.randint(-1, 2, fe.shape[0])
        fe[:, -1] = rng.randint(-1, 2, fe.shape[0])
    order = np.lexsort((col, row))
    return BipartiteGraph(row=row[order], col=col[order],
                          val=(rng.rand(e) - 0.5).astype(np.float32)[order],
                          c_feas=c_feas, v_feas=v_feas,
                          y_s=rng.randint(0, 3, m).astype(np.int32),
                          y_t=rng.randint(0, 3, n).astype(np.int32))


def setup(arch, device, seed=0, opt="adam"):
    """A seeded model, its optimizer (Adam capturable) and a dropout
    generator, the same for every call with the same arguments."""
    model = build_model(arch, torch.Generator().manual_seed(seed))
    model.to(device).train()
    optimizer = ttrainer.make_optimizer(model.parameters(), opt, 1e-3,
                                        capturable=opt == "adam")
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    return model, optimizer, gen


def graphs_for(model, device, seeds, size=(120, 200, 1500)):
    return [ttrainer.train_graph(model, lp_graph(s, *size), device)
            for s in seeds]


def assert_same_state(a, b):
    (ma, oa, ga), (mb, ob, gb) = a, b
    for (k, va), vb in zip(ma.state_dict().items(), mb.state_dict().values()):
        assert torch.equal(va, vb), k
    for pa, pb in zip(ma.parameters(), mb.parameters()):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(oa.state[pa][key], ob.state[pb][key]), key
    assert torch.equal(ga.get_state(), gb.get_state())


def eager_run(run, visits, acc_on):
    """The visits' steps as single train_step calls on the caller's
    stream, each loss read as the K=1 trainer reads it."""
    model, optimizer, gen = run
    losses, accs = [], []
    loss_fn = LOSS_REGISTRY["balanced"]
    for stack in visits:
        for gt, want in zip(stack, acc_on):
            loss, acc = ttrainer.train_step(model, optimizer, gt, loss_fn,
                                            gen, want)
            losses.append(float(loss))
            accs.append(float(acc) if acc is not None else -1.0)
    return losses, accs


@pytest.mark.cuda
@pytest.mark.parametrize("arch,stacked", [(GCN, True), (GCN, False),
                                          (GEN, False)],
                         ids=["gcn-stacked", "gcn-single", "gen-remat"])
def test_captured_steps_equal_eager_on_card(cuda_device, arch, stacked):
    """Three visits of one stack (eager + capture, replay, replay), each
    at its own learning rate (Adam's tensor lr, written in place), equal
    the same steps run singly, bit for bit: losses, accuracies where asked
    (-1 elsewhere), every parameter, Adam's moments and step counts, the
    dropout generator's state. The first visit launches the kernels; the
    capture records calls, which replays run."""
    k = 3
    acc_on = [True, False, True]
    runs = [setup(arch, cuda_device) for _ in range(2)]
    gts = graphs_for(runs[0][0], cuda_device, range(k) if stacked else [0])
    stack = gts if stacked else gts * k
    step = tscan.make_scan_train_step(runs[0][0], "balanced", runs[0][1],
                                      stacked=stacked, generator=runs[0][2])
    tscan.reset_counts()
    got_l, got_a = [], []
    want_l, want_a = [], []
    for lr in (1e-3, 1e-4, 1e-5):
        losses, accs = step(gts if stacked else gts[0], lr=lr,
                            acc_on=acc_on, k=k)
        got_l += losses.tolist()
        got_a += accs.tolist()
        ttrainer.set_lr(runs[1][1], lr)
        want = eager_run(runs[1], [stack], acc_on)
        want_l += want[0]
        want_a += want[1]
    assert step.captures == 1 and step.replays == 2
    assert got_l == want_l
    assert got_a == want_a and got_a[1] == -1.0 and got_a[0] >= 0
    assert_same_state(runs[0], runs[1])
    name = "gen_agg_fwd" if arch == GEN else "spmm_csr"
    assert tscan.CAPTURED[name] > 0
    assert tscan.REPLAYED[name] == 2 * tscan.CAPTURED[name]


@pytest.mark.cuda
def test_replays_in_permuted_order_match_eager(cuda_device):
    """Two stacks of different sizes whose graphs share one memory pool,
    replayed in an order that changes every round, equal the same steps
    run singly in that order, bit for bit."""
    k = 2
    runs = [setup(GCN, cuda_device, seed=3) for _ in range(2)]
    a = graphs_for(runs[0][0], cuda_device, [10, 11], (90, 150, 900))
    b = graphs_for(runs[0][0], cuda_device, [12, 13], (200, 260, 2500))
    order = [a, b, b, a, a, b, b, b, a]
    step = tscan.make_scan_train_step(runs[0][0], "balanced", runs[0][1],
                                      generator=runs[0][2])
    got = []
    for stack in order:
        got += step(stack, acc_on=[False] * k)[0].tolist()
    assert step.captures == 2 and step.replays == len(order) - 2
    want, _ = eager_run(runs[1], order, [False] * k)
    assert got == want
    assert_same_state(runs[0], runs[1])


@pytest.mark.cuda
def test_capture_that_cannot_be_made_raises(cuda_device):
    """Adam built without ``capturable`` keeps its step counts on the host:
    the first visit's eager steps run, the capture after them raises, and
    no other step is taken instead: the model equals one that took the 2
    steps singly."""
    runs = []
    for _ in range(2):
        model = build_model(GCN, torch.Generator().manual_seed(0))
        model.to(cuda_device).train()
        runs.append((model, ttrainer.make_optimizer(model.parameters()),
                     torch.Generator(device=cuda_device).manual_seed(1)))
    gts = graphs_for(runs[0][0], cuda_device, [0, 1])
    step = tscan.make_scan_train_step(runs[0][0], "balanced", runs[0][1],
                                      generator=runs[0][2])
    with pytest.raises(RuntimeError, match="capturable"):
        step(gts)
    torch.cuda.synchronize()
    assert step.captures == step.replays == 0 and not step.stacks
    eager_run(runs[1], [gts], [True, True])
    for (k, a), b in zip(runs[0][0].state_dict().items(),
                         runs[1][0].state_dict().values()):
        assert torch.equal(a, b), k


@pytest.mark.cuda
def test_sgd_graphs_follow_the_learning_rate(cuda_device):
    """SGD reads its learning rate on the host, so a graph holds it: a new
    learning rate makes a new graph (after an eager visit), and the steps
    equal single steps at each rate."""
    runs = [setup(GCN, cuda_device, seed=5, opt="sgd") for _ in range(2)]
    gts = graphs_for(runs[0][0], cuda_device, [20, 21])
    step = tscan.make_scan_train_step(runs[0][0], "balanced", runs[0][1],
                                      generator=runs[0][2])
    got, want = [], []
    for lr in (0.1, 0.1, 0.1, 0.01, 0.01, 0.01):
        got += step(gts, lr=lr)[0].tolist()
        ttrainer.set_lr(runs[1][1], lr)
        want += eager_run(runs[1], [gts], [False, False])[0]
    assert step.captures == 2 and step.replays == 4
    assert got == want
    for pa, pb in zip(runs[0][0].parameters(), runs[1][0].parameters()):
        assert torch.equal(pa, pb)


@pytest.mark.cuda
def test_optimizer_state_loads_into_either_form_on_card(cuda_device):
    """A train state saved by the capturable Adam loads into the default
    one and back; both then take the same step from it."""
    run = setup(GCN, cuda_device, seed=7)
    gts = graphs_for(run[0], cuda_device, [30])
    loss_fn = LOSS_REGISTRY["balanced"]
    ttrainer.train_step(run[0], run[1], gts[0], loss_fn, run[2])
    saved = run[1].state_dict()
    plain = ttrainer.make_optimizer(run[0].parameters(), "adam", 1e-3)
    ttrainer.load_optimizer_state(plain, saved)
    p0 = next(run[0].parameters())
    assert plain.state[p0]["step"].device.type == "cpu"
    assert not plain.param_groups[0]["capturable"]
    back = ttrainer.make_optimizer(run[0].parameters(), "adam", 1e-3,
                                   capturable=True)
    ttrainer.load_optimizer_state(back, plain.state_dict())
    assert back.state[p0]["step"].device == p0.device
    assert torch.is_tensor(back.param_groups[0]["lr"])
    ttrainer.train_step(run[0], back, gts[0], loss_fn, run[2])
    assert float(back.state[p0]["step"]) == 2.0
