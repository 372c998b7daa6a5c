"""Rank side of the port's multi-process tests, and their launcher.

``launch(world, outdir, cases)`` starts ``world`` processes of this script
on the CPU under gloo, with the environment ``torch.distributed.run`` gives
its ranks (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, a free
``MASTER_PORT`` on 127.0.0.1), waits for them with a timeout and kills
them after it.  Each rank joins through ``parallel.multihost.init_from_env``,
runs the named cases in order and pickles each result to
``outdir/<case>.<rank>.pkl``.  Cases read their inputs from
``outdir/inputs.pkl``, which the test writes (numpy params of tiny
widths; the trainers run in f64).  This module imports no jax: the tests
compare its results with JAX in their own process.

    python tests/torch_dist_worker.py OUTDIR CASE [CASE ...]
"""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

BATCH = 4  # batch size of the epoch cases: 2 scenes a rank at dp 2
# agents per scene: 7 scenes in the A=4 bucket (its last batch 3 real
# scenes, 2 + 1 over two ranks) and 5 in the A=8 bucket (its last batch one
# real scene: rank 1 of dp 2 holds only padding)
SIZES = (2, 3, 4, 3, 2, 4, 3, 6, 5, 7, 8, 6)
POOL = dict(hidden_dim=16, cell_side=0.6, n=4, out_dim=16)
WIDTHS = dict(embedding_dim=8, hidden_dim=16)
CLI_TINY = ["--type", "directional", "--n", "4", "--hidden-dim", "16",
            "--coordinate-embedding-dim", "8", "--pool_dim", "16", "--batch_size", "2",
            "--device", "cpu"]


# ------------------------------------------------------------------ launcher
def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(world: int, outdir: str, cases, timeout: float = 240, python_flags=()):
    """Run ``cases`` in ``world`` ranks; raise with every rank's output if
    one fails or the run outlasts ``timeout`` seconds (all are killed)."""
    port = free_port()
    procs = []
    for rank in range(world):
        env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": str(world),
               "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world),
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
               "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
        log = open(os.path.join(outdir, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen([sys.executable, *python_flags, __file__, outdir, *cases],
                                       cwd=outdir, env=env, stdout=log,
                                       stderr=subprocess.STDOUT), log))
    failed = []
    try:
        for rank, (proc, _) in enumerate(procs):
            try:
                if proc.wait(timeout=timeout) != 0:
                    failed.append(rank)
            except subprocess.TimeoutExpired:
                failed.append(rank)
                break
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
            log.close()
    if failed:
        logs = ""
        for r in range(world):
            with open(os.path.join(outdir, f"rank{r}.log")) as f:
                logs += f"--- rank {r}\n" + f.read()[-4000:] + "\n"
        raise AssertionError(f"ranks {failed} of {world} failed or timed out:\n{logs}")


def result(outdir: str, case: str, rank: int = 0):
    with open(os.path.join(outdir, f"{case}.{rank}.pkl"), "rb") as f:
        return pickle.load(f)


# -------------------------------------------------------------------- inputs
def scenes(seed=8, sizes=SIZES, row_class=None):
    """(filename, scene id, paths) of random-walk scenes of ``sizes`` agents,
    21 frames, some agents appearing late (rows of ``row_class``, the
    port's ``TrackRow`` by default)."""
    if row_class is None:
        from trajnetplusplusbaselines_torch.data.rows import TrackRow as row_class
    rng = np.random.default_rng(seed)
    out = []
    for sid, n in enumerate(sizes):
        xy = rng.normal(scale=0.15, size=(21, n, 2)).cumsum(axis=0)
        xy += rng.uniform(-2, 2, size=(1, n, 2))
        paths = []
        for p in range(n):
            first = 0 if p == 0 else int(rng.choice([0, 0, 2, 6]))
            paths.append([row_class(10 * f, 100 * sid + p, float(xy[f, p, 0]),
                                    float(xy[f, p, 1])) for f in range(first, 21)])
        out.append(("synth", sid, paths))
    return out


def lstm_model():
    from trajnetplusplusbaselines_torch.models.lstm import LSTM
    from trajnetplusplusbaselines_torch.ops.pooling import GridBasedPooling

    return LSTM(pool=GridBasedPooling(type_="directional", **POOL), **WIDTHS)


def sgan_model():
    from trajnetplusplusbaselines_torch.models.sgan import SGAN, LSTMDiscriminator, LSTMGenerator
    from trajnetplusplusbaselines_torch.ops.pooling import GridBasedPooling

    def pool():
        return GridBasedPooling(type_="directional", **POOL)

    return SGAN(LSTMGenerator(pool=pool(), noise_dim=4, **WIDTHS),
                LSTMDiscriminator(pool=pool(), **WIDTHS), k=2)


def vae_model():
    from trajnetplusplusbaselines_torch.models.vae import VAE
    from trajnetplusplusbaselines_torch.ops.pooling import GridBasedPooling

    return VAE(pool=GridBasedPooling(type_="directional", **POOL), num_modes=2, latent_dim=8,
               **WIDTHS)


MODELS = {"lstm": lstm_model, "sgan": sgan_model, "vae": vae_model}


def initial_params(kind, seed=0):
    """A tiny model's initial params as numpy (f32; the trainers here take
    them in f64)."""
    import torch

    from trajnetplusplusbaselines_torch.utils.convert import params_to_numpy

    return params_to_numpy(MODELS[kind]().init_params(torch.Generator().manual_seed(seed)))


def f64(tree):
    import torch

    from trajnetplusplusbaselines_torch.utils.convert import params_from_jax

    return params_from_jax(tree, dtype=torch.float64)


def trainer(kind, params, mesh=None, augment=True, **kw):
    """The port's trainer of ``kind`` at ``BATCH`` from numpy ``params``."""
    from trajnetplusplusbaselines_torch.trainers import ensemble, sgan, vae
    from trajnetplusplusbaselines_torch.trainers import lstm as lstm_trainer
    from trajnetplusplusbaselines_torch.trainers.common import step_lr

    args = {"batch_size": BATCH, "augment": augment, "save_every": 10 ** 9, "val_flag": False,
            "mesh": mesh, **kw}
    if kind == "sgan":
        return sgan.Trainer(sgan_model(), f64(params), step_lr(1e-3, 10), step_lr(1e-3, 10),
                            seed=7, **args)
    if kind == "vae":
        return vae.Trainer(vae_model(), f64(params), step_lr(1e-3, 10), seed=7, **args)
    if kind == "ensemble":
        stacked = ensemble.stack_params([f64(p) for p in params])
        return ensemble.EnsembleTrainer(lstm_model(), stacked, step_lr(1e-3, 10), [5, 6], **args)
    return lstm_trainer.Trainer(lstm_model(), f64(params), step_lr(1e-3, 10), seed=7, **args)


def train_epochs(tr, epochs=2):
    """Run ``epochs`` epochs on ``scenes()``; (the full params as numpy,
    each epoch's per-batch losses)."""
    from trajnetplusplusbaselines_torch.trainers.common import SceneDataset
    from trajnetplusplusbaselines_torch.utils.convert import params_to_numpy

    ds = SceneDataset(scenes(), 9, False)
    losses = []
    for epoch in range(epochs):
        tr.train(ds, epoch)
        losses.append(np.array(tr.epoch_losses))
    return params_to_numpy(tr._full(tr.params, autograd=False)), losses


def step_batches(s=8, a=4, n=3):
    """``n`` random-walk batches [21, S, A, 2] as ``make_sharded_train_step``
    takes them."""
    out = []
    for k in range(n):
        rng = np.random.default_rng(k)
        xy = rng.normal(size=(21, s, a, 2)).cumsum(axis=0)
        out.append((xy, np.ones((21, s, a), bool), np.zeros((s, a, 2)), np.ones((s, a), bool),
                    np.ones(s, bool)))
    return out


def sharded_steps(params, mesh, batches):
    """(full params after the steps, losses) of ``make_sharded_train_step``
    on ``mesh`` (None: one process)."""
    from trajnetplusplusbaselines_torch.parallel import make_sharded_train_step
    from trajnetplusplusbaselines_torch.parallel.mesh import gather_params, param_shardings
    from trajnetplusplusbaselines_torch.trainers.common import make_optimizer
    from trajnetplusplusbaselines_torch.utils.convert import params_to_numpy

    model = lstm_model()
    step, place_batch, place_params = make_sharded_train_step(model, make_optimizer, mesh,
                                                              batch_size=batches[0][0].shape[1])
    placed, opt, losses = place_params(f64(params)), None, []
    for b in batches:
        placed, opt, loss = step(placed, opt, *place_batch(*b))
        losses.append(float(loss))
    if mesh is not None:
        placed = gather_params(mesh, placed, param_shardings(mesh, f64(params)), autograd=False)
    return params_to_numpy(placed), losses


# --------------------------------------------------------------------- cases
def _inputs(outdir):
    with open(os.path.join(outdir, "inputs.pkl"), "rb") as f:
        return pickle.load(f)


def _mesh(dp, tp):
    import torch

    from trajnetplusplusbaselines_torch.parallel import make_mesh

    return make_mesh(dp * tp, dp, tp, torch.device("cpu"))


def case_lstm_dp2(outdir):
    return train_epochs(trainer("lstm", _inputs(outdir)["lstm"], _mesh(2, 1)))


def case_lstm_tp2(outdir):
    """Two epochs at (1, 2) with a clip that bites; each rank's block and
    Adam moment shapes."""
    tr = trainer("lstm", _inputs(outdir)["lstm"], _mesh(1, 2), clip_grad=0.05)
    params, losses = train_epochs(tr)
    moments = tr.optimizer.state_dict()["state"]
    shapes = {p: (tuple(leaf.shape), tuple(moments[i]["exp_avg"].shape),
                  tuple(moments[i]["exp_avg_sq"].shape))
              for i, (p, leaf) in enumerate(zip(tr.paths, tr.leaves))}
    return params, losses, shapes, tr._full_adam_state(tr.optimizer, tr.paths)


def case_lstm_dp2tp2(outdir):
    """(2, 2), no augmentation (the draws JAX's trainer cannot share)."""
    return train_epochs(trainer("lstm", _inputs(outdir)["lstm"], _mesh(2, 2), augment=False))


def case_sgan_dp2tp2(outdir):
    return train_epochs(trainer("sgan", _inputs(outdir)["sgan"], _mesh(2, 2)))


def case_vae_dp2(outdir):
    return train_epochs(trainer("vae", _inputs(outdir)["vae"], _mesh(2, 1)))


def case_ensemble_dp2(outdir):
    return train_epochs(trainer("ensemble", _inputs(outdir)["ensemble"], _mesh(2, 1)), epochs=1)


def case_step_tp1(outdir):
    return sharded_steps(_inputs(outdir)["lstm"], _mesh(2, 1), step_batches())


def case_step_tp2(outdir):
    return sharded_steps(_inputs(outdir)["lstm"], _mesh(1, 2), step_batches())


def case_rollout(outdir):
    """``make_sharded_rollout`` of 6 scenes of 4 agents over two ranks."""
    from trajnetplusplusbaselines_torch.parallel import make_sharded_rollout

    xy, mask, goals, slot, _ = step_batches(s=6)[0]
    rollout, place_batch = make_sharded_rollout(lstm_model(), _mesh(2, 1))
    placed = place_batch(xy, mask, goals, slot)
    out = rollout(f64(_inputs(outdir)["lstm"]), *placed)
    return [x.numpy() for x in out], tuple(placed[0].shape)


def case_agree(outdir):
    """process_info, all_processes_agree on equal and on different arrays,
    broadcast_from_zero."""
    from trajnetplusplusbaselines_torch.parallel import multihost

    rank, world = multihost.process_info()
    return {"info": (rank, world),
            "equal": multihost.all_processes_agree(np.arange(5)),
            "different": multihost.all_processes_agree(np.arange(5) + rank),
            "reshaped": multihost.all_processes_agree(
                np.zeros(4).reshape((2, 2) if rank else (4,))),
            "broadcast": multihost.broadcast_from_zero({"rank": rank})}


def case_plan_drift(outdir):
    """A rank whose epoch plan drifted: ``place_plan_on_mesh`` raises on
    every rank; an equal plan passes."""
    from trajnetplusplusbaselines_torch.trainers.common import place_plan_on_mesh

    mesh = _mesh(2, 1)
    idx, valid = np.arange(8).reshape(2, 4), np.ones((2, 4), bool)
    place_plan_on_mesh(mesh, idx, valid)
    drifted = idx[:, ::-1] if mesh.rank else idx  # the same indices, reordered
    try:
        place_plan_on_mesh(mesh, drifted, valid)
    except RuntimeError as exc:
        return str(exc)
    return None


def case_serve(outdir):
    """In ``outdir/serve``, on the split ``split`` (three test datasets):
    ``lstm_cli`` with ``model.pkl``; again, which finds the predictions and
    only scores; ``--fill_missing``, which raises; ``classical_cli --cv``."""
    from trajnetplusplusbaselines_torch.evaluator import classical_cli, lstm_cli

    os.chdir(os.path.join(outdir, "serve"))
    argv = ["--path", "split", "--output", "model.pkl", "--device", "cpu", "--batch_scenes", "2"]
    table = lstm_cli.main(argv)
    again = lstm_cli.main(argv)
    try:
        lstm_cli.main([*argv, "--fill_missing"])
        fill = None
    except ValueError as exc:
        fill = str(exc)
    cv = classical_cli.main(["--path", "split", "--cv", "--device", "cpu"])
    return {"scored": table is not None, "fill_missing": fill,
            "results": None if table is None else table.results,
            "again": None if again is None else again.results,
            "cv": None if cv is None else cv.results}


def case_cli_dp2(outdir):
    """``trainers.lstm.main --dp 2`` in ``outdir/cli``: the trainer's epoch
    losses."""
    from trajnetplusplusbaselines_torch.trainers import lstm as lstm_trainer

    os.chdir(os.path.join(outdir, "cli"))
    tr = lstm_trainer.main(argv=["--path", "synthset", *CLI_TINY, "--epochs", "2",
                                 "--augment", "-o", "dp", "--dp", "2"])
    return tr.epoch_losses


def case_cli_tp2(outdir):
    """``trainers.lstm.main --tp 2`` for an epoch, then resumed for a second
    with ``--load-full-state``: each rank's block shapes after the resume."""
    from trajnetplusplusbaselines_torch.trainers import lstm as lstm_trainer

    os.chdir(os.path.join(outdir, "cli"))
    base = ["--path", "synthset", *CLI_TINY, "--augment", "--tp", "2"]
    lstm_trainer.main(argv=[*base, "--epochs", "1", "-o", "tp"])
    tr = lstm_trainer.main(argv=[*base, "--epochs", "2", "-o", "tpr", "--load-full-state",
                                 "OUTPUT_BLOCK/synthset/lstm_directional_tp.pkl.state"])
    moments = tr.optimizer.state_dict()["state"]
    return {p: (tuple(leaf.shape), tuple(moments[i]["exp_avg"].shape))
            for i, (p, leaf) in enumerate(zip(tr.paths, tr.leaves))}


CASES = {name[len("case_"):]: fn for name, fn in globals().items() if name.startswith("case_")}


def main(outdir, cases):
    import torch

    from trajnetplusplusbaselines_torch.parallel.multihost import init_from_env

    torch.set_num_threads(1)
    init_from_env("cpu", timeout_s=120)
    rank = int(os.environ["RANK"])
    for case in cases:
        cwd = os.getcwd()
        try:
            out = CASES[case](outdir)
        finally:
            os.chdir(cwd)
        with open(os.path.join(outdir, f"{case}.{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
