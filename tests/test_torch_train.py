"""The fused training slice on the CPU, the port against the JAX package:
the fused forward, the all-hop fused forward, its loss and gradients, and
the A³GNN trainer with ``fused_gather_agg=True, sampling_device="device"``
end to end, for all four model families, from the JAX parameters carried
across by ``models/convert.py``.

Tolerances: logits and the loss within atol = rtol = 1e-5 (f32; the CPU
matmuls of the two frameworks sum in different orders); gradients within
rtol 1e-5, entries near zero within 1e-5 of the tensor's largest; step
losses over 4 Adam steps within rel 1e-4 (Adam's normalisation magnifies
f32 rounding in the gradients); cache statistics, modeled memory and
accuracies exactly equal (the sampled batches are bit-identical)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.gnn import gnn_config as jx_gnn_config
from repro.core.a3gnn import A3GNNTrainer as JxTrainer
from repro.graph.synthetic import dataset_like as jx_dataset
from repro.models.gnn import gnn_forward as jx_forward
from repro.models.gnn import gnn_forward_allfused as jx_forward_allfused
from repro.models.gnn import gnn_loss_allfused as jx_loss_allfused
from repro.models.params import init_params as jx_init
from repro.models.gnn import decls_gnn as jx_decls
from repro_torch.configs.gnn import gnn_config
from repro_torch.core.a3gnn import A3GNNTrainer, make_trainer
from repro_torch.core.cache import FeatureCache
from repro_torch.core.feature_plane import DeviceFeaturePlane
from repro_torch.core.sampling import NeighborSampler
from repro_torch.graph.batch import batch_device_arrays, compute_level_caps
from repro_torch.graph.synthetic import dataset_like
from repro_torch.launch.train import build_parser, main
from repro_torch.models.convert import params_from_jax
from repro_torch.models.gnn import (gnn_forward, gnn_forward_allfused,
                                    gnn_loss_allfused,
                                    make_train_step_allfused)
from repro_torch.models.params import leaves
from repro_torch.train.optimizer import make_adamw

MODELS = ["graphsage", "gcn", "gat", "gin"]
TOL = dict(atol=1e-5, rtol=1e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def fused_batch():
    """A sampled batch at level caps with its encoded layer-0 inputs from a
    device plane whose small cache leaves misses in the sideband."""
    cfg = gnn_config("products", smoke=True)
    g = dataset_like(cfg, seed=0)
    seeds = np.flatnonzero(g.train_mask)[:cfg.batch_size]
    mb = NeighborSampler(g, cfg.fanout, seed=1).sample(seeds)
    caps = compute_level_caps(len(seeds), cfg.fanout, g.num_nodes)
    arrays = batch_device_arrays(mb, level_caps=caps)
    plane = DeviceFeaturePlane(g, FeatureCache(g, 0.2, "static"),
                               device="cpu")
    enc, aux, table = plane.fused_inputs(mb.input_ids, arrays["pads"][0])
    assert (enc[:len(mb.input_ids)] < 0).any() and (enc >= 0).any()
    feats = np.zeros((arrays["pads"][0], g.feat_dim), np.float32)
    feats[:len(mb.input_ids)] = g.features[mb.input_ids]
    return {"enc": enc.numpy(), "aux": aux.numpy(), "table": table.numpy(),
            "features": feats, "neigh_idxs": arrays["neigh_idxs"],
            "labels": arrays["labels"]}


def _jax_params(model, seed=0):
    cfg = jx_gnn_config("products", smoke=True, model=model)
    return cfg, jx_init(jx_decls(cfg), jax.random.PRNGKey(seed))


def _t(a):
    return torch.from_numpy(a)


@pytest.mark.parametrize("model", MODELS)
def test_fused_forward_matches_jax(fused_batch, model):
    jcfg, jp = _jax_params(model)
    cfg = gnn_config("products", smoke=True, model=model)
    b = fused_batch
    params = params_from_jax(_np(jp), "cpu")
    idx_j = [jnp.asarray(i) for i in b["neigh_idxs"]]
    idx_t = [_t(i) for i in b["neigh_idxs"]]
    want = jx_forward(jp, jnp.asarray(b["features"]), idx_j, jcfg,
                      fused=True)
    got = gnn_forward(params, _t(b["features"]), idx_t, cfg, fused=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the fused and unfused forms are one function
    np.testing.assert_allclose(
        gnn_forward(params, _t(b["features"]), idx_t, cfg).numpy(),
        got.numpy(), **TOL)

    want = jx_forward_allfused(jp, jnp.asarray(b["enc"]),
                               jnp.asarray(b["aux"]), jnp.asarray(b["table"]),
                               idx_j, jcfg)
    got = gnn_forward_allfused(params, _t(b["enc"]), _t(b["aux"]),
                               _t(b["table"]), idx_t, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("model", MODELS)
def test_allfused_loss_and_grads_match_jax(fused_batch, model):
    jcfg, jp = _jax_params(model, seed=1)
    cfg = gnn_config("products", smoke=True, model=model)
    b = fused_batch
    (loss_j, acc_j), g_j = jax.value_and_grad(
        lambda p: jx_loss_allfused(
            p, jnp.asarray(b["enc"]), jnp.asarray(b["aux"]),
            jnp.asarray(b["table"]), [jnp.asarray(i) for i in b["neigh_idxs"]],
            jnp.asarray(b["labels"]), jcfg), has_aux=True)(jp)
    params = params_from_jax(_np(jp), "cpu")
    flat = [p.requires_grad_(True) for p in leaves(params)]
    loss, acc = gnn_loss_allfused(
        params, _t(b["enc"]), _t(b["aux"]), _t(b["table"]),
        [_t(i) for i in b["neigh_idxs"]], _t(b["labels"]), cfg)
    grads = torch.autograd.grad(loss, flat)
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), **TOL)
    assert float(acc) == pytest.approx(float(acc_j))
    names = [f"{i}.{k}" for i, layer in enumerate(params["layers"])
             for k in sorted(layer)]
    ref = [np.asarray(x) for x in jax.tree.leaves(g_j)]
    for name, got, want in zip(names, grads, ref, strict=True):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)


def test_allfused_step_counts_calls(fused_batch):
    cfg = gnn_config("products", smoke=True)
    _, jp = _jax_params("graphsage")
    params = params_from_jax(_np(jp), "cpu")
    opt = make_adamw()
    state = opt.init(params)
    step = make_train_step_allfused(cfg, opt)
    b = fused_batch
    for _ in range(2):
        params, state, loss, _ = step(
            params, state, _t(b["enc"]), _t(b["aux"]), _t(b["table"]),
            [_t(i) for i in b["neigh_idxs"]], _t(b["labels"]))
        assert np.isfinite(float(loss))
    assert step.counters == {"calls": 2}
    assert state["count"] == 2


@pytest.mark.parametrize("model", MODELS)
def test_fused_training_slice_matches_jax(model):
    # a static cache of 0.2 MB leaves misses in the sideband.  (Not FIFO:
    # the JAX device plane's CPU upload of the host storage can race the
    # in-place FIFO insert that follows the encoding, so its losses vary
    # from run to run there; the FIFO stream is held row by row in
    # tests/test_torch_fused_agg.py.)
    kw = dict(smoke=True, model=model, fused_gather_agg=True,
              sampling_device="device", cache_policy="static",
              cache_volume_mb=0.2)
    cfg_j, cfg_t = jx_gnn_config("products", **kw), gnn_config("products",
                                                                **kw)
    trj = JxTrainer(jx_dataset(cfg_j, seed=0), cfg_j, seed=0)
    trt = A3GNNTrainer(dataset_like(cfg_t, seed=0), cfg_t, seed=0,
                       device="cpu")
    trt.params = params_from_jax(_np(trj.params), "cpu")
    rj = trj.run_epochs(1, max_steps_per_epoch=4)
    rt = trt.run_epochs(1, max_steps_per_epoch=4)
    assert rt.stats.steps == rj.stats.steps == 4
    assert np.isfinite(rt.stats.losses).all()
    np.testing.assert_allclose(rt.stats.losses, rj.stats.losses, rtol=1e-4,
                               atol=0)
    assert rt.cache_hit_rate == rj.cache_hit_rate
    assert 0 < rt.cache_hit_rate < 1                 # hits and misses both
    assert dataclasses.asdict(trt.cache.stats) == \
        dataclasses.asdict(trj.cache.stats)
    assert rt.memory_bytes == rj.memory_bytes
    assert trt.modeled_memory(rt.stats, "mode1", 4) == \
        trj.modeled_memory(rj.stats, "mode1", 4)
    assert rt.steps_per_epoch == rj.steps_per_epoch
    assert trt._step_allfused.counters["calls"] == 4
    # evaluation from the same parameters gives the same accuracy
    trt.params = params_from_jax(_np(trj.params), "cpu")
    assert trt.evaluate() == trj.evaluate()
    assert trt.predicted_accuracy_drop() == trj.predicted_accuracy_drop()


def test_launch_train_runs_the_slice_on_cpu(capsys):
    assert main(["--arch", "graphsage-products", "--smoke", "--device",
                 "cpu", "--sampling-device", "device", "--fused-gather-agg",
                 "--steps", "3"]) == 0
    out = capsys.readouterr().out
    assert "[result]" in out and "[stages]" in out


@pytest.mark.parametrize("argv", [
    ["--arch", "qwen3-4b", "--smoke", "--device", "cpu", "--autotune"],
    ["--arch", "qwen3-4b", "--smoke", "--device", "cpu"],
])
def test_unported_branches_refuse(argv):
    # LM training, tuned or not, is not ported
    with pytest.raises(SystemExit, match="not ported yet"):
        main(argv)


def test_launch_train_autotune_runs_on_cpu(capsys):
    assert main(["--arch", "graphsage-products", "--smoke", "--device",
                 "cpu", "--sampling-device", "device", "--fused-gather-agg",
                 "--autotune", "--episodes-autotune", "3", "--steps",
                 "3"]) == 0
    out = capsys.readouterr().out
    assert all(f"[episode {i}]" in out for i in range(3))
    assert "[autotune] best=episode" in out and "[pareto]" in out


def test_launch_train_runs_partitions(capsys):
    assert main(["--arch", "graphsage-products", "--smoke", "--device",
                 "cpu", "--partitions", "2", "--steps", "2"]) == 0
    out = capsys.readouterr().out
    assert "[partition] 2 partitions" in out
    assert "[restore] fresh trainer restored from step 2" in out


def test_make_trainer_builds_multipartition():
    from repro_torch.core.multipart import MultiPartitionTrainer
    cfg = gnn_config("products", smoke=True, partitions=2)
    tr = make_trainer(dataset_like(cfg, seed=0), cfg, device="cpu")
    assert isinstance(tr, MultiPartitionTrainer) and len(tr.slots) == 2
    assert isinstance(make_trainer(dataset_like(cfg, seed=0),
                                   cfg.replace(partitions=1), device="cpu"),
                      A3GNNTrainer)


def test_device_defaults_to_cuda():
    assert build_parser().parse_args(["--arch", "x"]).device == "cuda"


@pytest.mark.parametrize("fused", [True, False])
def test_trainer_records_the_fused_stage_split(fused):
    cfg = gnn_config("products", smoke=True, fused_gather_agg=fused,
                     sampling_device="device")
    tr = A3GNNTrainer(dataset_like(cfg, seed=0), cfg, seed=0, device="cpu")
    res = tr.run_epochs(1, max_steps_per_epoch=3)
    want = res.stats.steps if fused else 0
    assert list(tr.fused_parts) == ["pad", "encode", "copy", "step"]
    for part in tr.fused_parts.values():
        assert len(part) == want and all(t >= 0 for t in part)
    # the parts lie inside the train stage that the pipeline timed
    assert sum(map(sum, tr.fused_parts.values())) <= res.stats.t_train
