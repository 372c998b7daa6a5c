"""The train step as CUDA graphs (``trainers/graphs.py``), on the CPU.

There is nothing to capture on the CPU, so a stand-in graph
(``ReplayGraph``) drives ``StepGraphs``' bookkeeping: which calls run
eagerly, which capture, which replay; the launch counters (a capture adds
nothing, each replay what its capture's wrappers counted); a fresh loss per
call; the leaves' version bumps; a restored optimizer state dropping the
graphs.  Driven through ``StepGraphs`` that way, two epochs of the port's
trainer equal the JAX trainer's.  Also: which trainer takes graphs, the
tensor learning rate ``set_lr`` fills in place, the Adam sidecar with the
step count in a tensor, and the constants made on the device for a capture
(the loss's unit normal, the plain grid's cell side and offset), bit for
bit the host-made ones they replace.  The ``cuda`` test holds graph steps to
eager steps on the card; where jax is not installed run it without the
suite's conftest:

    python -m pytest tests/test_torch_train_graphs.py -m cuda --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from trajnetplusplusbaselines_torch import losses
from trajnetplusplusbaselines_torch.ops.cuda import fused_step, fused_train
from trajnetplusplusbaselines_torch.ops.pooling.grid import GridBasedPooling
from trajnetplusplusbaselines_torch.trainers import common, graphs, vae
from trajnetplusplusbaselines_torch.trainers.lstm import Trainer


class ReplayGraph:
    """``graphs.CudaGraph``'s stand-in on the CPU.  Capturing runs the step
    once, as a capture records it, then puts back every tensor the step
    changed (a capture computes nothing); a replay runs the recorded step on
    the static buffers, writes its loss into the static loss, and takes back
    what the wrappers counted (a replay launches kernels, not wrappers)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer

    def _tensors(self):
        leaves = [p for group in self.optimizer.param_groups for p in group["params"]]
        return leaves + [t for state in self.optimizer.state.values() for t in state.values()
                         if isinstance(t, torch.Tensor)]

    def capture(self, fn):
        tensors = self._tensors()
        saved = [t.detach().clone() for t in tensors]
        self.fn, self.loss = fn, fn()
        with torch.no_grad():
            for t, s in zip(tensors, saved):
                t.copy_(s)
        return self.loss

    def replay(self):
        before = graphs.read_counters()
        loss = self.fn()
        graphs.add_counters([b - a for a, b in zip(graphs.read_counters(), before)])
        with torch.no_grad():
            self.loss.copy_(loss)


@pytest.fixture
def counters():
    """The launch counters, zeroed, restored after the test."""
    saved = graphs.read_counters()
    graphs.add_counters([-n for n in saved])
    yield
    graphs.add_counters([s - n for s, n in zip(saved, graphs.read_counters())])


def _counting_setup(monkeypatch=None, warm_calls=3):
    """A leaf, its optimizer, ``StepGraphs`` on ``ReplayGraph`` (each key
    eager for ``warm_calls`` calls) and a step function that counts 19 grid
    and 2 fused launches, adds its batch's sum to the leaf in place and
    returns 2 * sum + start_length; ``ran`` lists the tensor each call ran
    on."""
    if monkeypatch is not None:
        monkeypatch.setattr(graphs, "WARM_CALLS", warm_calls)
    assert graphs.WARM_CALLS == warm_calls
    leaf = torch.zeros((), dtype=torch.float64, requires_grad=True)
    optimizer = torch.optim.SGD([leaf], lr=0.1)
    step_graphs = graphs.StepGraphs(optimizer, new_graph=lambda: ReplayGraph(optimizer))
    ran = []

    def fn(xy, mask, scene, goals, slot, start_length):
        ran.append(xy)
        fused_step.directional_grid.launches += 19
        fused_step.fused_dlstm_step.launches += 2
        with torch.no_grad():
            leaf.add_(xy.sum())
        return (xy.sum() * 2 + start_length).detach()

    return leaf, optimizer, step_graphs, fn, ran


def _batch(value, s=2, a=3, goals=True):
    xy = torch.full((21, s, a, 2), float(value), dtype=torch.float64)
    mask = torch.ones((21, s, a), dtype=torch.bool)
    return (xy, mask, torch.ones(s, dtype=torch.bool),
            torch.zeros((s, a, 2), dtype=torch.float64) if goals else None,
            torch.ones((s, a), dtype=torch.bool))


def _launches():
    return fused_step.directional_grid.launches, fused_step.fused_dlstm_step.launches


# ------------------------------------------------------------------ the path
@pytest.mark.parametrize("device,mesh,want", [
    ("cuda", None, True), ("cuda:1", None, True), ("cpu", None, False),
    ("cuda", object(), False), ("cpu", object(), False)])
def test_one_card_in_one_process_takes_graphs(device, mesh, want):
    assert graphs.takes_graphs(torch.device(device), mesh) is want


def test_cpu_trainers_stay_eager_with_a_float_rate():
    """On the CPU the trainer keeps ``make_optimizer``'s Adam (a float rate, the step
    count on the host) and no graphs; the VAE trainer never takes them."""
    from trajnetplusplusbaselines_torch.models.lstm import LSTM

    model = LSTM(embedding_dim=4, hidden_dim=8)
    params = model.init_params(torch.Generator().manual_seed(0))
    trainer = Trainer(model, params, common.step_lr(1e-3, 10))
    assert trainer.graphs is None
    group = trainer.optimizer.param_groups[0]
    assert isinstance(group["lr"], float) and not group["capturable"]
    assert Trainer.capturable_adam and not vae.Trainer.capturable_adam


def test_set_lr_fills_a_tensor_rate_in_place():
    leaves = [torch.zeros(3, requires_grad=True)]
    optimizer = graphs.capturable_optimizer(leaves)
    rate = optimizer.param_groups[0]["lr"]
    assert optimizer.param_groups[0]["capturable"]
    assert rate.dim() == 0 and rate.dtype == torch.float32 and float(rate) == np.float32(1e-3)
    common.set_lr(optimizer, 1e-4)
    assert optimizer.param_groups[0]["lr"] is rate
    assert float(rate) == np.float32(1e-4)


def test_set_lr_replaces_a_float_rate():
    optimizer = common.make_optimizer([torch.zeros(3, requires_grad=True)])
    common.set_lr(optimizer, 1e-4)
    assert optimizer.param_groups[0]["lr"] == 1e-4


# ------------------------------------------------------------- bookkeeping
def test_first_calls_of_a_key_run_eagerly_on_their_batch(counters):
    leaf, _, step_graphs, fn, ran = _counting_setup()
    batches = [_batch(k) for k in range(1, 4)]
    for k, batch in enumerate(batches, 1):
        loss = step_graphs.step(fn, batch, 0)
        assert ran[-1] is batch[0]  # the batch itself: no static buffer yet
        assert float(loss) == 2 * batch[0].sum()
        assert _launches() == (19 * k, 2 * k)
    assert not step_graphs.graphs


def test_capture_counts_nothing_and_each_replay_its_capture(counters):
    leaf, _, step_graphs, fn, ran = _counting_setup()
    for k in range(1, 4):
        step_graphs.step(fn, _batch(k), 0)
    # the 4th call captures (counted, then taken back) and replays once
    batch = _batch(4)
    loss = step_graphs.step(fn, batch, 0)
    (captured,) = step_graphs.graphs.values()
    assert captured.counts == (2, 19, 0) + (0,) * len(fused_train.KERNELS)
    assert ran[-1] is captured.inputs[0] and ran[-1] is not batch[0]
    assert _launches() == (19 * 4, 2 * 4)
    assert float(loss) == 2 * batch[0].sum()
    for k in (5, 6):
        step_graphs.step(fn, _batch(k), 0)
        assert _launches() == (19 * k, 2 * k)
    assert len(ran) == 7  # three eager calls, the capture, three replays
    assert float(leaf.detach()) == sum(_batch(k)[0].sum() for k in range(1, 7))  # one update a call


def test_each_replay_returns_a_fresh_loss(counters, monkeypatch):
    _, _, step_graphs, fn, _ = _counting_setup(monkeypatch, warm_calls=1)
    got = [step_graphs.step(fn, _batch(k), 1) for k in range(1, 6)]
    (captured,) = step_graphs.graphs.values()
    assert all(loss is not captured.loss for loss in got)
    assert len({loss.data_ptr() for loss in got}) == len(got)
    assert [float(x) for x in got] == [2 * _batch(k)[0].sum() + 1 for k in range(1, 6)]


def test_replays_bump_the_leaves_versions(counters, monkeypatch):
    leaf, _, step_graphs, fn, _ = _counting_setup(monkeypatch, warm_calls=1)
    step_graphs.step(fn, _batch(1), 0)
    step_graphs.step(fn, _batch(2), 0)  # capture and replay
    for k in (3, 4):
        version = leaf._version
        step_graphs.step(fn, _batch(k), 0)
        assert leaf._version > version


@pytest.mark.parametrize("other", ["shape", "start_length", "goals", "dtype"])
def test_another_key_warms_up_anew(counters, monkeypatch, other):
    _, _, step_graphs, fn, ran = _counting_setup(monkeypatch, warm_calls=2)
    for k in range(1, 4):
        step_graphs.step(fn, _batch(k), 0)
    assert len(step_graphs.graphs) == 1
    batch, sl = _batch(9), 0
    if other == "shape":
        batch = _batch(9, a=4)
    elif other == "start_length":
        sl = 2
    elif other == "goals":
        batch = _batch(9, goals=False)
    else:
        batch = (batch[0].float(), *batch[1:])
    step_graphs.step(fn, batch, sl)
    assert ran[-1] is batch[0] and len(step_graphs.graphs) == 1


def test_a_restored_optimizer_state_drops_the_graphs(counters, monkeypatch):
    _, optimizer, step_graphs, fn, ran = _counting_setup(monkeypatch, warm_calls=1)
    for k in range(1, 4):
        step_graphs.step(fn, _batch(k), 0)
    assert step_graphs.graphs
    optimizer.load_state_dict(optimizer.state_dict())
    batch = _batch(4)
    step_graphs.step(fn, batch, 0)
    assert ran[-1] is batch[0] and not step_graphs.graphs


def test_two_epochs_through_graphs_match_jax_trainer(monkeypatch):
    """Two epochs of the port's trainer whose steps go through
    ``StepGraphs`` (each key warmed once, then captured and replayed on
    ``ReplayGraph``) against JAX's ``Trainer.train``, f64: the same leaves."""
    from trajnetplusplusbaselines_tpu.trainers import common as jcommon

    from .test_torch_train import _leaves_close, _scenes, _trainers

    scenes = _scenes(8, [2, 3, 4, 3, 2, 4, 3, 6, 5, 7])  # buckets A=4 (7 scenes), A=8 (3)
    jtr, tr = _trainers("directional", batch_size=3, seed=5)
    monkeypatch.setattr(graphs, "WARM_CALLS", 1)
    tr.graphs = graphs.StepGraphs(tr.optimizer, new_graph=lambda: ReplayGraph(tr.optimizer))
    jdata, data = jcommon.SceneDataset(scenes, None, 9, False), common.SceneDataset(scenes, 9,
                                                                                    False)
    for epoch in range(2):
        jtr.train(jdata, epoch)
        tr.train(data, epoch)
    assert len(tr.graphs.graphs) == 2  # one a bucket
    _leaves_close(tr.params, jtr.params, 1e-8)


# --------------------------------------------------------------- the sidecar
def test_adam_sidecar_round_trips_a_tensor_step():
    """A capturable Adam (its step count a tensor) restores a sidecar and
    writes it back the same, as ``make_optimizer``'s Adam does."""
    rng = np.random.default_rng(0)
    shapes = {"a/w": (3, 2), "b": (4,)}
    saved = {path: {"step": 7.0, "exp_avg": rng.normal(size=shape).astype(np.float32),
                    "exp_avg_sq": rng.random(shape).astype(np.float32)}
             for path, shape in shapes.items()}
    for make in (graphs.capturable_optimizer, common.make_optimizer):
        leaves = [torch.zeros(shape, requires_grad=True) for shape in shapes.values()]
        optimizer = make(leaves)
        common.adam_state_from_numpy(optimizer, list(shapes), saved)
        assert all(isinstance(s["step"], torch.Tensor) for s in optimizer.state.values())
        got = common.adam_state_to_numpy(optimizer, list(shapes))
        assert list(got) == list(saved)
        for path, want in saved.items():
            assert got[path]["step"] == want["step"]
            for key in ("exp_avg", "exp_avg_sq"):
                np.testing.assert_array_equal(got[path][key], want[key])


# --------------------------------------------------------------- constants
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_unit_normal_is_the_host_made_constant(dtype):
    got = losses.unit_normal(torch.zeros(2, dtype=dtype))
    want = torch.tensor([0.0, 0.0, 1.0, 1.0, 0.0], dtype=dtype)
    assert got.dtype == dtype and torch.equal(got.view(torch.uint8), want.view(torch.uint8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("cell_side,n,pool_size,front", [
    (0.6, 12, 1, False), (0.6, 12, 1, True), (0.6, 12, 2, False), (2.0, 4, 1, False),
    (0.3, 5, 3, True), (1.1, 7, 1, False)])
def test_cell_frame_is_the_host_made_constants(dtype, cell_side, n, pool_size, front):
    pool = GridBasedPooling(type_="directional", cell_side=cell_side, n=n,
                            pool_size=pool_size, front=front)
    side, offset = pool.cell_frame(torch.zeros(1, dtype=dtype))
    nps = n * pool_size
    want_side = torch.tensor(cell_side / pool_size, dtype=dtype)
    want_offset = torch.tensor([nps / 2.0, 0.0 if front else nps / 2.0], dtype=dtype)
    for got, want in ((side, want_side), (offset, want_offset)):
        assert got.shape == want.shape and got.dtype == dtype
        assert torch.equal(got.reshape(-1).view(torch.uint8), want.reshape(-1).view(torch.uint8))


# ------------------------------------------- the smoke's reading of a graph
def _dot_node(i, label):
    """One node of ``cudaGraphDebugDotPrint``'s verbose DOT, as the CUDA 12
    runtime writes it."""
    return (f'"graph_1_node_{i}"[style="bold" shape="record" label="{{{label}\n'
            f'| {{ID | {i} (topoId: {30 - i}) | {{name}}\\<\\<\\<32,256,2576\\>\\>\\>}}\n'
            '| {{node handle | func handle} | {0x000000000BFB5DF0 | 0x000000000B21C5F0}}\n'
            '| {cooperative | 0}\n| {priority | 0}\n}"];\n\n')


GRID_F32 = ("_ZN52_GLOBAL__N__91dd1b0d_19_directional_grid_cu_d70c936623directional_grid_"
            "kernelIfLb1EEEvPKT_S3_PKhS5_iiffNS_4GeomEiiPS1_")
GRID_BF16 = ("_ZN52_GLOBAL__N__91dd1b0d_19_directional_grid_cu_d70c936623directional_grid_"
             "kernelI13__nv_bfloat16Lb1EEEvPKT_S4_PKhS6_iiffNS_4GeomEiiPS2_")
FUSED = ("_ZN46_GLOBAL__N__087d2626_13_fused_step_cu_61bf913017fused_step_kernelENS_5SceneENS_"
         "7WeightsEPKfS3_PfS4_S4_Ph")
OTHER = "_ZN2at6native29vectorized_elementwise_kernelILi4ENS0_11FillFunctorIfEEEEviT0_T1_"


@pytest.mark.parametrize("names,want", [
    ([GRID_F32] * 19, {"directional_grid": 19}),
    ([GRID_F32, OTHER, GRID_BF16, GRID_BF16], {"directional_grid": 1,
                                               "directional_grid_bf16": 2}),
    ([FUSED, OTHER, FUSED, GRID_F32], {"fused_dlstm_step": 2, "directional_grid": 1}),
    ([OTHER, None, OTHER], {}),
    ([], {})])
def test_smoke_reads_the_port_kernels_of_a_graph(names, want):
    """``chip_smoke.graph_kernel_nodes`` counts each kernel node of the
    port's kernels once, by launch counter, in a DOT dump of a graph with
    other kernels, a memset node and the edges between nodes."""
    import chip_smoke

    dot = 'digraph dot {\nsubgraph cluster_1 {\nlabel="graph_1" graph[style="dashed"];\n'
    for i, name in enumerate(names):
        dot += (_dot_node(i, "MEMSET") if name is None
                else _dot_node(i, "KERNEL").replace("{name}", name))
    dot += "".join(f'"graph_1_node_{i}" -> "graph_1_node_{i + 1}";\n'
                   for i in range(len(names) - 1))
    dot += "}\n}\n"
    assert chip_smoke.graph_kernel_nodes(dot) == want


# --------------------------------------------------------------- on the card
@pytest.mark.cuda
def test_graph_steps_equal_eager_steps_on_the_card():
    """A small directional LSTM trained on the card for 8 steps of two
    batch shapes, through graphs and eagerly with the same capturable Adam:
    the same losses and leaves within 1e-6 relative, 19 grid-stage launches
    a step both ways."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from trajnetplusplusbaselines_torch.models.lstm import LSTM
    from trajnetplusplusbaselines_torch.ops.cuda import build

    build.load_library()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    model = LSTM(pool=GridBasedPooling(type_="directional", hidden_dim=32, cell_side=0.6, n=6,
                                       out_dim=32), embedding_dim=16, hidden_dim=32)
    batches = []
    for k in range(8):
        s, a = (4, 5) if k % 2 else (3, 8)
        xy = rng.normal(scale=0.15, size=(21, s, a, 2)).cumsum(axis=0).astype(np.float32)
        batches.append(common.Batch(torch.from_numpy(xy).to(dev),
                                    torch.ones((21, s, a), dtype=torch.bool, device=dev),
                                    torch.ones(s, dtype=torch.bool, device=dev),
                                    torch.zeros((s, a, 2), device=dev),
                                    torch.ones((s, a), dtype=torch.bool, device=dev)))
    runs = {}
    for name in ("graphs", "eager"):
        params = model.init_params(torch.Generator().manual_seed(0), device=dev)
        trainer = Trainer(model, params, common.step_lr(1e-3, 10))
        assert isinstance(trainer.graphs, graphs.StepGraphs)
        if name == "eager":
            trainer.graphs = None
        before = fused_step.directional_grid.launches
        got = [trainer.train_step(*b) for b in batches]
        torch.cuda.synchronize()
        assert fused_step.directional_grid.launches - before == 19 * len(batches)
        runs[name] = (torch.stack(got).cpu(), [x.detach().cpu() for x in trainer.leaves])
    (loss_g, leaves_g), (loss_e, leaves_e) = runs["graphs"], runs["eager"]
    torch.testing.assert_close(loss_g, loss_e, rtol=1e-6, atol=0)
    for g, e in zip(leaves_g, leaves_e):
        torch.testing.assert_close(g, e, rtol=1e-6, atol=1e-6 * float(e.abs().max()))
