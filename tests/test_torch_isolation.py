"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, and a CUDA request where
there is no CUDA raises instead of falling back to the CPU."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

IMPORT_ALL = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps({"modules": names,
                  "leaked": sorted(m for m in sys.modules
                                   if m.split(".")[0] in ("jax", "repro"))}))
"""


def _run(args, cwd=ROOT):
    return subprocess.run([sys.executable, *args], cwd=cwd, text=True,
                          capture_output=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(SRC)})


def test_port_and_chip_smoke_import_no_jax_and_no_repro():
    proc = _run(["-c", IMPORT_ALL, str(ROOT / "chip_smoke.py")])
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("kernels.gather.ops", "kernels.segment_agg.ops",
                 "kernels.fused_gather_agg.ops", "launch.serve",
                 "launch.train", "models.transformer", "models.api",
                 "serve.engine", "kernels.flash_attention.ops",
                 "kernels.reservoir.ops", "train.checkpoint",
                 "train.fault_tolerance", "launch.mesh",
                 "distributed.collectives", "core.multipart",
                 "core.autotune", "core.autotune.space",
                 "core.autotune.pareto", "core.autotune.surrogate",
                 "core.autotune.ppo", "core.autotune.controller",
                 "models.moe", "models.ssm", "models.hybrid",
                 "configs.glm4_9b", "configs.minitron_8b",
                 "configs.qwen2_moe_a2_7b", "configs.kimi_k2_1t_a32b",
                 "configs.mamba2_1_3b", "configs.zamba2_7b",
                 "models.encdec", "configs.whisper_medium",
                 "configs.qwen2_vl_2b", "train.optimizer", "train.trainer",
                 "train.data", "launch.group", "launch.dryrun",
                 "launch.footprint",
                 "train.compression", "distributed.pp",
                 "distributed.sharding", "models.convert",
                 "models.layers"):
        assert f"repro_torch.{name}" in got["modules"]
    assert got["leaked"] == []


def test_device_plane_on_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.configs.gnn import gnn_config
    from repro_torch.core.feature_plane import (DeviceFeaturePlane,
                                                make_feature_plane)
    from repro_torch.graph.synthetic import dataset_like
    g = dataset_like(gnn_config("products", smoke=True), seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceFeaturePlane(g, None, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_feature_plane(g, None, "auto")       # auto follows cuda, no probe


def test_multipartition_on_cuda_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.configs.gnn import gnn_config
    from repro_torch.core.a3gnn import make_trainer
    from repro_torch.graph.synthetic import dataset_like
    from repro_torch.launch.train import main
    cfg = gnn_config("products", smoke=True, partitions=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_trainer(dataset_like(cfg, seed=0), cfg)   # device defaults cuda
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--arch", "graphsage-products", "--smoke", "--partitions", "2",
              "--ckpt-dir", str(tmp_path)])


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "alone"])
def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cwd = ROOT
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path)
        cwd = tmp_path
    proc = _run(["chip_smoke.py"], cwd=cwd)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
