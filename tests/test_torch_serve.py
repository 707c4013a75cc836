"""The slice end to end, on the CPU: warm-up training and node serving
through the device feature plane, the port against the JAX package.

Tolerances: warm-up losses within rel 1e-4 over 4 steps (Adam's
normalisation magnifies gradient differences of f32 rounding, so this is
wider than the 1e-5 of one forward); logits within atol 1e-4, with equal
predictions wherever the top-2 margin is above 1e-3; cache statistics and
plane counters exactly equal (the sampled batches are bit-identical)."""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs.gnn import gnn_config as jx_gnn_config
from repro.core.a3gnn import A3GNNTrainer as JxTrainer
from repro.graph.storage import FeatureStore as JxStore
from repro.graph.synthetic import dataset_like as jx_dataset
from repro.serve.gnn_engine import GNNInferenceEngine as JxEngine
from repro.serve.gnn_engine import GNNRequest as JxRequest
from repro_torch.configs.gnn import gnn_config
from repro_torch.core.a3gnn import A3GNNTrainer
from repro_torch.graph.storage import FeatureStore
from repro_torch.graph.synthetic import dataset_like
from repro_torch.launch.serve import build_parser, main, run_gnn_serve
from repro_torch.models.convert import params_from_jax
from repro_torch.models.params import leaves
from repro_torch.serve.gnn_engine import GNNInferenceEngine, GNNRequest

PLANE_COUNTERS = ("gather_dispatches", "gather_rows", "sync_full_uploads",
                  "sync_row_scatters", "sync_rows_scattered",
                  "sync_bytes_uploaded")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _counters(plane):
    return {k: getattr(plane, k) for k in PLANE_COUNTERS}


def _serve(eng, req_cls, nodes, rid0=0):
    for rid, v in enumerate(nodes, start=rid0):
        eng.submit(req_cls(rid=rid, node=int(v)))
    eng.run_to_completion()
    done = sorted(eng.completed, key=lambda r: r.rid)[-len(nodes):]
    assert [r.status for r in done] == ["done"] * len(nodes)
    return np.stack([r.logits for r in done]), np.array([r.pred for r in done])


def _same_predictions(lj, lt, pj, pt):
    np.testing.assert_allclose(lt, lj, atol=1e-4, rtol=0)
    top2 = np.sort(lj, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 1e-3
    assert np.array_equal(pj[clear], pt[clear])


@pytest.mark.parametrize("policy", ["static", "fifo"])
def test_serving_slice_matches_jax(policy):
    cfg_j = jx_gnn_config("products", smoke=True, sampling_device="device",
                          cache_policy=policy)
    cfg_t = gnn_config("products", smoke=True, sampling_device="device",
                       cache_policy=policy)
    trj = JxTrainer(jx_dataset(cfg_j, seed=0), cfg_j, seed=0)
    trt = A3GNNTrainer(dataset_like(cfg_t, seed=0), cfg_t, seed=0,
                       device="cpu")
    trt.params = params_from_jax(_np(trj.params), "cpu")
    pj, pt = trj.make_pipeline(), trt.make_pipeline()
    try:
        sj, st = pj.run(max_steps=4), pt.run(max_steps=4)
    finally:
        pj.shutdown()
        pt.shutdown()
    assert st.steps == sj.steps == 4
    np.testing.assert_allclose(st.losses, sj.losses, rtol=1e-4, atol=0)
    assert dataclasses.asdict(trt.cache.stats) == \
        dataclasses.asdict(trj.cache.stats)
    assert _counters(pt.plane) == _counters(pj.plane)

    # both engines hold the JAX trainer's post-warm-up parameters
    ej = JxEngine.from_trainer(trj, batch=4, plane=pj.plane, seed=0)
    et = GNNInferenceEngine.from_trainer(trt, batch=4, plane=pt.plane, seed=0)
    et.set_weights({"params": params_from_jax(_np(trj.params), "cpu")})
    g = trj.graph
    nodes = np.random.default_rng(0).choice(np.flatnonzero(g.test_mask), 16)
    lj, predj = _serve(ej, JxRequest, nodes)
    lt, predt = _serve(et, GNNRequest, nodes)
    _same_predictions(lj, lt, predj, predt)
    assert dataclasses.asdict(trt.cache.stats) == \
        dataclasses.asdict(trj.cache.stats)
    assert _counters(pt.plane) == _counters(pj.plane)

    # a streamed update of a served node reaches both re-queries
    sj_, st_ = JxStore(trj.graph), FeatureStore(trt.graph)
    ej.plane.subscribe_to(sj_)
    et.plane.subscribe_to(st_)
    row = np.full((1, g.feat_dim), 1.0, np.float32)
    sj_.update_rows(nodes[:1], row)
    st_.update_rows(nodes[:1], row)
    lj, predj = _serve(ej, JxRequest, nodes[:1], rid0=16)
    lt, predt = _serve(et, GNNRequest, nodes[:1], rid0=16)
    _same_predictions(lj, lt, predj, predt)
    assert _counters(pt.plane) == _counters(pj.plane)


def test_launch_serve_runs_the_slice_on_cpu(capsys):
    args = build_parser().parse_args(
        ["--gnn", "--arch", "graphsage-products", "--smoke", "--device",
         "cpu", "--sampling-device", "device", "--queries", "16"])
    rep = run_gnn_serve(args)
    losses = rep["warmup"].losses
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert [r.status for r in rep["served"]] == ["done"] * 16
    assert rep["requery"].status == "done" and rep["requery"].rid == 16
    assert rep["engine"].plane.backend == "device"
    assert all(p.device.type == "cpu" for p in leaves(rep["trainer"].params))
    # CPU tensors run the plain gather: no kernel launch is counted
    assert rep["launches_warmup"] == rep["launches_serve"] == 0
    assert "[stream]" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["--arch", "mamba2-1.3b"],        # an LM family the port does not serve
    ["--arch", "whisper-medium"],     # and another (the fabric is ported)
])
def test_unported_branches_refuse(argv):
    with pytest.raises(SystemExit, match="not ported yet"):
        main(argv)


def test_device_defaults_to_cuda():
    assert build_parser().parse_args(["--arch", "x"]).device == "cuda"
