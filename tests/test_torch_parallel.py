"""The port's parallel layer (``graph_transformer_tpu_torch/parallel/``) in
gloo processes on the CPU against the JAX package's on the 8-device virtual
CPU mesh (``tests/conftest.py``), at W = 2 and W = 4 ranks.

One job a world size, spawned once for the module (``parallel/launch.py``,
120 s deadline, a port bound to 0), runs ``dryrun.run_regimes`` on inputs
built from JAX's weights, batches, candidates and P(k) table, and JAX's
``make_shard_map_train_step`` test's step (``tests/torch_parallel_worker.py``):

- regime 1: ``make_spmd_train_step`` on a (W/2, 2) mesh at W = 4 (W, 1 at
  2) at rate 0 against JAX's on the same global batch: the loss within 1e-5
  relative, every gradient leaf within relative L2 1e-5;
  ``make_shard_map_train_step`` likewise;
- ``halo_gather`` of the features bit for bit against JAX's under
  ``shard_map``;
- regime 2: ``make_halo_train_step(deterministic=True)`` against JAX's,
  the loss within 1e-5 relative, the gradients within relative L2 1e-5;
- regime 3: the overlapped step against the masked blocking one on the
  edge-balanced partition, the loss within 1e-6 relative, rows within
  1e-6;
- regime 1 on ACT's per-layer encoder against the model's own pass on the
  whole batch;
- regime 4: the sharded folds' epoch losses and accuracies equal bit for
  bit to the unsharded runner's, also for plateau_window + 2 epochs with
  the plateau rule firing, and ``run_cv_on_device(mesh=...)``'s to
  the unsharded on-device CV's; ``cli.tenfold --vmap_folds --shard_folds 2``
  in two launched ranks prints what the unsharded CLI prints.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from graph_transformer_tpu.config import ModelConfig as JaxModelConfig
from graph_transformer_tpu.data.batching import BatchBuilder as JaxBuilder
from graph_transformer_tpu.data.tu import (
    synthetic_powerlaw_dataset as jax_synthetic,
)
from graph_transformer_tpu.models.u2gnn_sup import U2GNNSup as JaxSup
from graph_transformer_tpu.ops import losses as jlosses
from graph_transformer_tpu.parallel import edge_partition as jep
from graph_transformer_tpu.parallel import spmd as jspmd
from graph_transformer_tpu.parallel.mesh import make_mesh as jax_make_mesh
from graph_transformer_tpu.sampling import log_uniform as jlu
from graph_transformer_tpu_torch.data.tu import synthetic_powerlaw_dataset
from graph_transformer_tpu_torch.models.u2gnn_sup import U2GNNSup
from graph_transformer_tpu_torch.parallel import dryrun
from graph_transformer_tpu_torch.parallel.edge_partition import (
    ShardedBatchBuilder,
)
from graph_transformer_tpu_torch.cli import tenfold
from graph_transformer_tpu_torch.parallel.launch import launch
from graph_transformer_tpu_torch.parallel.launch import main as launch_main
from graph_transformer_tpu_torch.parallel.mesh import local_mesh
from graph_transformer_tpu_torch.train.cv_ondevice import run_cv_on_device
from graph_transformer_tpu_torch.train.tenfold_vmap import TenfoldVmapRunner
from graph_transformer_tpu_torch.weights import params_from_jax
from test_torch_batcher import jax_assembler
from torch_parallel_worker import sleeper, worker

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

WORLDS = (2, 4)
TOL = 1e-5


def flatten_sup(p):
    tree = {}
    for i, enc in enumerate(p.encoders):
        for f in dataclasses.fields(enc):
            tree[f"encoders.{i}.{f.name}"] = np.asarray(getattr(enc, f.name))
    tree["head_w"] = np.asarray(p.head_w)
    tree["head_b"] = np.asarray(p.head_b)
    return tree


def flatten_halo(p):
    tree = {f"encoders.{i}.{f.name}": np.asarray(getattr(enc, f.name))
            for i, enc in enumerate(p.encoders)
            for f in dataclasses.fields(enc)}
    tree["ss.weight"] = np.asarray(p.ss.weight)
    tree["ss.bias"] = np.asarray(p.ss.bias)
    return tree


def flatten_grads(tree_fn, g):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree_fn(g).items()}


def capture():
    """An optax transformation whose state after ``update`` is the
    gradient (and whose updates are 0), so JAX's steps hand it back."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def close_loss(got, want, tol=TOL):
    assert abs(got - want) <= tol * abs(want), (got, want)


def close_leaves(got, want, tol=TOL):
    assert set(got) == set(want)
    for k in want:
        assert rel_l2(got[k], want[k]) <= tol, (k, rel_l2(got[k], want[k]))


# ------------------------------------------------------------ the inputs
def sup_inputs():
    """Regime 1 (JAX's dry-run shapes) with JAX's weights and batch."""
    inputs = dryrun.tiny_inputs()
    r1 = inputs.r1
    dj = jax_synthetic(num_graphs=16, mean_nodes=24, seed=0)
    jcfg = JaxModelConfig(num_timesteps=2, num_hidden_layers=2,
                          ff_hidden_size=64)
    jm = JaxSup(dj.feature_dim, dj.num_classes, jcfg)
    jp = jm.init(jax.random.key(0))
    jb = JaxBuilder(dj, 8, 4, pad_multiple=32, seed=0,
                    backend="numpy").build(list(range(8)))
    for f in ("x", "neigh", "graph_id", "node_mask", "labels"):
        np.testing.assert_array_equal(getattr(r1.batch, f).numpy(),
                                      np.asarray(getattr(jb, f)))
    r1.state = params_from_jax(flatten_sup(jp))
    return inputs, dj, jm, jp, jb


def jax_spmd(W, dj, jm, jp, jb):
    mesh = jax_make_mesh(model_parallel=dryrun.model_parallel_for(W),
                         devices=jax.devices()[:W])

    def loss_fn(p, b, key):
        del key
        scores = jm.apply(p, b, rng=None)
        t = jlosses.label_smoothing(b.labels, dj.num_classes, 0.1)
        return jlosses.soft_cross_entropy(scores, t)

    opt = capture()
    step = jspmd.make_spmd_train_step(loss_fn, opt, mesh, 64, jp,
                                      donate=False)
    _, grads, loss = step(jspmd.shard_params(jp, mesh, 64), opt.init(jp),
                          jspmd.shard_batch(jb, mesh), jax.random.key(1))
    return float(loss), flatten_grads(flatten_sup, grads)


def halo_inputs(inputs):
    """Regime 2 with JAX's weights, candidates and P(k) table."""
    h = inputs.r2
    n = h.x.shape[0]
    jparams = jep.init_halo_unsup_params(jax.random.key(2), h.layers,
                                         h.x.shape[1], h.ff_hidden, n,
                                         num_timesteps=1)
    key = jax.random.key(h.seed)
    k_cand, _ = jax.random.split(key)
    h.state = params_from_jax(flatten_halo(jparams))
    h.sample_ids = torch.from_numpy(np.array(
        jlu.sample_log_uniform_unique(k_cand, n, h.nsampled)))
    h.probs = torch.from_numpy(np.array(jlu.log_uniform_probs(n)))
    h.return_gathered = True
    return jparams, key


def jax_halo(W, h, jparams, key):
    mesh = jax_make_mesh(model_parallel=1, devices=jax.devices()[:W])
    plan = jep.build_halo_plan(h.neigh, W)
    opt = capture()
    step = jep.make_halo_train_step(opt, mesh, h.x.shape[0], h.nsampled,
                                    num_timesteps=1, donate=False,
                                    deterministic=True)
    _, grads, loss = step(jparams, opt.init(jparams), jnp.asarray(h.x), plan,
                          key)
    from functools import partial

    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    @partial(shard_map, mesh=mesh,
             in_specs=(P("data"), P(), P("data"), P("data"), P("data")),
             out_specs=P("data"), check_vma=False)
    def run(x_local, export_idx, imp_src, imp_row, imp_loc):
        return jep.halo_gather(x_local, export_idx, imp_src[0], imp_row[0],
                               imp_loc[0])

    gathered = run(jnp.asarray(h.x), plan.export_idx, plan.import_src,
                   plan.import_row, plan.import_local)
    return (float(loss), flatten_grads(flatten_halo, grads),
            np.asarray(gathered))


def shard_map_case(W):
    """JAX's shard_map step test's data (32 graphs of ~60 nodes, 4 graphs a
    shard) and its step on a W-device mesh."""
    jax_assembler()
    dj = jax_synthetic(num_graphs=32, mean_nodes=60, seed=0)
    dt = synthetic_powerlaw_dataset(num_graphs=32, mean_nodes=60, seed=0)
    per_shard = [np.arange(i * 8, i * 8 + 4) for i in range(W)]
    sj = jep.ShardedBatchBuilder(dj, W, batch_size=4, num_neighbors=4,
                                 pad_multiple=64, seed=0).build(per_shard)
    st = ShardedBatchBuilder(dt, W, batch_size=4, num_neighbors=4,
                             pad_multiple=64, seed=0).build(per_shard)
    np.testing.assert_array_equal(st.neigh.numpy(), np.asarray(sj.neigh))
    jcfg = JaxModelConfig(num_timesteps=1, num_hidden_layers=1,
                          ff_hidden_size=16)
    jm = JaxSup(dj.feature_dim, dj.num_classes, jcfg)
    jp = jm.init(jax.random.key(0))

    def loss_fn(p, local, key):
        del key
        scores = jm.apply(p, local, rng=None)
        t = jlosses.label_smoothing(local.labels, dj.num_classes, 0.1)
        return -jnp.sum(t * jax.nn.log_softmax(scores, axis=-1))

    mesh = jax_make_mesh(model_parallel=1, devices=jax.devices()[:W])
    opt = capture()
    step = jep.make_shard_map_train_step(loss_fn, opt, mesh, donate=False)
    with mesh:
        _, grads, loss = step(jp, opt.init(jp), sj, jax.random.key(1))
    from graph_transformer_tpu_torch.config import ModelConfig

    case = {"D": dt.feature_dim, "C": dt.num_classes,
            "cfg": ModelConfig(num_timesteps=1, num_hidden_layers=1,
                               ff_hidden_size=16),
            "state": params_from_jax(flatten_sup(jp)), "stacked": st}
    return case, float(loss), flatten_grads(flatten_sup, grads)


def unsharded_runner(r4):
    runner = TenfoldVmapRunner(r4.ds, r4.cfg, folds=r4.folds, device="cpu")
    losses = np.stack([runner.train_epoch() for _ in range(r4.epochs)])
    best, _, _, cv_losses, cv_accs = run_cv_on_device(
        r4.ds, r4.cfg, folds=r4.folds, return_history=True,
        epochs_per_dispatch=1, device="cpu")
    return losses, runner.evaluate(), (best, cv_losses, cv_accs)


def per_layer_inputs():
    """Regime 1 on the per-layer encoder: ACT (K9/K10's plain versions,
    the ponder cost in the loss), the dry run's batch."""
    r1 = dryrun.tiny_inputs().r1
    mcfg = dataclasses.replace(r1.cfg.model, recurrence="act")
    model = U2GNNSup(r1.feature_dim, r1.num_classes, mcfg, seed=3)
    return dataclasses.replace(
        r1, cfg=dataclasses.replace(r1.cfg, model=mcfg),
        state={k: v.clone() for k, v in model.state_dict().items()})


def plateau_inputs():
    """Regime 4 for plateau_window + 2 epochs at a rate of 0.5 on ten folds
    of 4 training and 4 test graphs: one batch a fold an epoch, so the
    plateau rule's step size is 1 and the rule cuts some folds' rates."""
    r4 = dryrun.tiny_inputs().r4
    c = r4.cfg
    cfg = dataclasses.replace(
        c, train=dataclasses.replace(c.train, learning_rate=0.5))
    n = len(r4.ds.labels)
    folds = [(np.arange(4 * f, 4 * f + 4), np.arange(4 * f + 4, 4 * f + 8) % n)
             for f in range(10)]
    return dataclasses.replace(r4, cfg=cfg, folds=folds,
                               epochs=cfg.train.plateau_window + 2)


def one_thread(fn, *args):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks run
    try:
        return fn(*args)
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jobs():
    """Each world size's job (one spawn each) and JAX's references; the
    unsharded references of the per-layer step and of the plateau run."""
    per_layer, plateau = per_layer_inputs(), plateau_inputs()
    out = {"per_layer": dryrun.regime1_reference(per_layer, "cpu"),
           "plateau": one_thread(dryrun.regime4, local_mesh("cpu"), plateau,
                                 "cpu")}
    for W in WORLDS:
        inputs, dj, jm, jp, jb = sup_inputs()
        jparams, key = halo_inputs(inputs)
        case, sm_loss, sm_grads = shard_map_case(W)
        ranks = launch(worker, W, inputs, case, per_layer, plateau,
                       backend="gloo", device="cpu", timeout_s=120)
        out[W] = dict(ranks=ranks, inputs=inputs,
                      spmd=jax_spmd(W, dj, jm, jp, jb),
                      halo=jax_halo(W, inputs.r2, jparams, key),
                      shard_map=(sm_loss, sm_grads),
                      cv=one_thread(unsharded_runner, inputs.r4))
    return out


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("W", WORLDS)
def test_ranks_form_one_group(jobs, W):
    ranks = jobs[W]["ranks"]
    assert [r["rank"] for r in ranks] == list(range(W))
    assert {(r["world"], r["backend"], r["device"]) for r in ranks} == {
        (W, "gloo", "cpu")}
    assert ranks[0]["r1"]["mesh"] == ((W, 1) if W == 2 else (2, 2))


@pytest.mark.parametrize("W", WORLDS)
def test_spmd_step_matches_jax(jobs, W):
    loss, grads = jobs[W]["spmd"]
    for r in jobs[W]["ranks"]:
        close_loss(r["r1"]["loss"], loss)
        assert np.isfinite(r["r1"]["loss_train"])
    # the summed gradients, equal on every rank, come from the first
    assert [r["r1"]["grads"] is None for r in jobs[W]["ranks"]] == [
        False] + [True] * (W - 1)
    close_leaves(jobs[W]["ranks"][0]["r1"]["grads"], grads)


@pytest.mark.parametrize("W", WORLDS)
def test_shard_map_step_matches_jax(jobs, W):
    loss, grads = jobs[W]["shard_map"]
    for r in jobs[W]["ranks"]:
        close_loss(r["shard_map"]["loss"], loss)
        close_leaves(r["shard_map"]["grads"], grads)


@pytest.mark.parametrize("W", WORLDS)
def test_halo_gather_bit_for_bit(jobs, W):
    want = jobs[W]["halo"][2]
    got = np.concatenate([r["r2"]["gathered"].numpy()
                          for r in jobs[W]["ranks"]])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("W", WORLDS)
def test_halo_step_matches_jax(jobs, W):
    loss, grads, _ = jobs[W]["halo"]
    for r in jobs[W]["ranks"]:
        close_loss(r["r2"]["loss"], loss)
        assert np.isfinite(r["r2"]["loss_stochastic"])
    close_leaves(jobs[W]["ranks"][0]["r2"]["grads"], grads)


@pytest.mark.parametrize("W", WORLDS)
def test_overlapped_halo_matches_blocking(jobs, W):
    for r in jobs[W]["ranks"]:
        r3 = r["r3"]
        close_loss(r3["loss_overlap"], r3["loss_blocking"], 1e-6)
        assert r3["max_row_diff"] <= 1e-6
        assert r3["grad_rel_l2"] <= 1e-5
        assert r3["valid_fraction"] < 1.0  # the partition pads
        assert np.isfinite(r3["loss_stochastic_overlap"])


@pytest.mark.parametrize("W", WORLDS)
def test_sharded_folds_equal_unsharded(jobs, W):
    losses, accs, _ = jobs[W]["cv"]
    runs = [r["r4"] for r in jobs[W]["ranks"] if r["r4"] is not None]
    assert len(runs) == dryrun.fold_ranks(10, W) == {2: 2, 4: 2}[W]
    for r4 in runs:
        assert r4["folds_per_rank"] == 10 // len(runs)
        np.testing.assert_array_equal(r4["losses"], losses)
        np.testing.assert_array_equal(r4["accs"][-1], accs)


@pytest.mark.parametrize("W", WORLDS)
def test_spmd_step_runs_per_layer_encoders(jobs, W):
    """The sharded step on ACT's per-layer encoder (the model's own forward,
    its ponder cost summed over the shards) against the model's pass on the
    whole batch on one process."""
    want = jobs["per_layer"]
    ranks = jobs[W]["ranks"]
    for r in ranks:
        close_loss(r["per_layer"]["loss"], want["loss"])
        assert np.isfinite(r["per_layer"]["loss_train"])
    close_leaves(ranks[0]["per_layer"]["grads"], want["grads"])


@pytest.mark.parametrize("W", WORLDS)
def test_sharded_folds_equal_unsharded_past_the_plateau(jobs, W):
    """plateau_window + 2 epochs: each epoch's losses and accuracies, and
    each fold's learning-rate scale, equal bit for bit to the unsharded
    runner's, with the plateau rule fired on some folds."""
    want = jobs["plateau"]
    assert (want["lr_scales"] < 1.0).any()
    runs = [r["plateau"] for r in jobs[W]["ranks"] if r["plateau"] is not None]
    assert len(runs) == dryrun.fold_ranks(10, W)
    for r4 in runs:
        np.testing.assert_array_equal(r4["losses"], want["losses"])
        np.testing.assert_array_equal(r4["accs"], want["accs"])
        np.testing.assert_array_equal(r4["lr_scales"],
                                      want["lr_scales"][r4["own"]])


@pytest.mark.parametrize("W", WORLDS)
def test_sharded_cv_on_device_equals_unsharded(jobs, W):
    want = jobs[W]["cv"][2]
    runs = [r["cv_on_device"] for r in jobs[W]["ranks"]
            if r["cv_on_device"] is not None]
    assert len(runs) == dryrun.fold_ranks(10, W)
    for run in runs:
        for got, w in zip((run["best"], run["losses"], run["accs"]), want):
            np.testing.assert_array_equal(got, w)


def test_cli_shard_folds_in_launched_ranks(tmp_path, capfd, monkeypatch):
    """``python -m ...parallel.launch --ranks 2 ... cli.tenfold
    --vmap_folds --shard_folds 2``: the first rank prints the unsharded
    CLI's fold lines and mean."""
    chip_smoke.write_ptc_like_tu(str(tmp_path), num_graphs=40, seed=2)
    flags = ["--dataset", "PTC", "--data_dir", str(tmp_path), "--batch_size",
             "4", "--ff_hidden_size", "16", "--num_neighbors", "3",
             "--num_epochs", "1", "--vmap_folds", "--device", "cpu"]
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tenfold.main(flags)
    finally:
        torch.set_num_threads(threads)
    want = [line for line in capfd.readouterr().out.splitlines()
            if line.startswith(("fold", "10-fold"))]
    assert launch_main(["--ranks", "2", "--backend", "gloo", "--device",
                        "cpu", "--timeout", "120",
                        "graph_transformer_tpu_torch.cli.tenfold", *flags,
                        "--shard_folds", "2", "--backend", "gloo"]) == 0
    got = [line for line in capfd.readouterr().out.splitlines()
           if line.startswith(("fold", "10-fold"))]
    assert len(want) == 11 and got == want


def test_hung_rank_times_out():
    """A rank past the job's deadline is killed and the launch raises."""
    with pytest.raises(TimeoutError):
        launch(sleeper, 1, 60, backend="gloo", device="cpu", timeout_s=5)
