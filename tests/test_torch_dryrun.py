"""The port's dry-run accounting (``repro_torch.launch.dryrun``) against
witnesses of its own: the JAX package's dry-run fails under the installed
jax (``tests/test_distributed.py::test_dryrun_cell_tiny_mesh``), so it is
held piece by piece.

  * FLOPs, at smoke size in f32, train (loss and backward) and prefill, for
    llama3.2-3b, qwen2-moe-a2.7b, mamba2-1.3b, zamba2-7b, whisper-medium and
    qwen2-vl-2b, against XLA's ``cost_analysis()`` of the same JAX step
    compiled for one CPU device (every scan unrolled, as the JAX dry-run's
    probes compile it):
      - the matrix products within [0.99, 1.0] of the compiled program's
        dot FLOPs (read from its HLO): equal where both packages compute
        the same products; JAX also runs as dots a few selections the port
        makes elementwise or by a gather (the MoE's one-hot routing
        weights, M-RoPE's stream select, parts of the SSD's backward);
      - the total (products and elementwise work) within [0.95, 1.0] of
        the cost analysis of the program JAX lowers, for all twelve;
      - and within [0.95, 1.0] of the compiled program's, where XLA's
        compile adds less than 5% to the program's count
        (``COMPILED_BAND``: every family but the SSD stacks, see there);
  * the depth probe exact: a depth-6 smoke config's count extrapolated
    from depths 2 and 4 (the hybrid: 1 and 2 groups) equals its direct
    count;
  * argument bytes equal to the sum from JAX's ``physical_specs``;
  * the JSON has the keys of JAX's ``run_cell``, numeric peak and temp
    bytes and transcendentals, and ``null`` where only XLA's compile
    gives a number;
  * ``flash_attention`` on ``meta``: the plain version, shape and backward;
  * the new modules of the port are walked and import no JAX.
"""
import ast
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as jx_get_config
from repro.configs.base import ShapeConfig as JShape
from repro.distributed import sharding as jx_sh
from repro.launch.xla_compat import cost_analysis_dict
from repro.models.api import build as jx_build
from repro.models.params import abstract_params as jx_abstract
from repro.models.unroll import force_unroll
from repro.train.optimizer import get_optimizer as jx_get_optimizer
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AbstractMesh, make_host_mesh

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["llama3.2-3b", "qwen2-moe-a2.7b", "mamba2-1.3b", "zamba2-7b",
         "whisper-medium", "qwen2-vl-2b"]
SMOKE = (2, 64)                    # batch, sequence
BAND = (0.95, 1.0)
# XLA's compile adds to the SSD stacks' counts (the compiled program's
# exceeds the lowered one's by 5.6-8.2% there, by 0.6-0.7% for
# llama3.2-3b), which no count of the program itself can follow
COMPILED_BAND = {"llama3.2-3b", "qwen2-moe-a2.7b", "whisper-medium",
                 "qwen2-vl-2b"}


def _jax_costs(arch, kind):
    """(lowered flops, compiled flops, compiled dot flops) of JAX's step."""
    cfg = jx_get_config(arch, smoke=True).replace(compute_dtype="float32")
    model = jx_build(cfg)
    spec = model.input_specs(JShape("x", kind, SMOKE[1], SMOKE[0]))
    params = jx_abstract(model.decls, dtype_override=jnp.dtype(
        cfg.param_dtype))
    with force_unroll(True):
        fn = (jax.jit(jax.value_and_grad(model.loss_fn, has_aux=True))
              if kind == "train" else jax.jit(model.prefill))
        lowered = fn.lower(params, spec["batch"])
        compiled = lowered.compile()
    lc = lowered.cost_analysis()
    lc = lc[0] if isinstance(lc, (list, tuple)) else lc
    return (float(lc["flops"]), float(cost_analysis_dict(compiled)["flops"]),
            hlo_dot_flops(compiled.as_text()))


_INSTR = re.compile(r"\s*(?:ROOT )?%?([\w.\-]+) = \w+\[([\d,]*)\]")


def hlo_dot_flops(text: str) -> float:
    """2 · (output elements) · (contracted size) over every ``dot`` of an
    HLO module's text."""
    dims, total = {}, 0
    for line in text.splitlines():
        m = _INSTR.match(line)
        if not m:
            continue
        dims[m.group(1)] = [int(d) for d in m.group(2).split(",") if d]
        if " dot(" not in line:
            continue
        lhs = dims[re.search(r" dot\(%?([\w.\-]+)", line).group(1)]
        cdims = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", line).group(1)
        k = math.prod(lhs[int(i)] for i in cdims.split(",") if i)
        total += 2 * math.prod(dims[m.group(1)]) * k
    return float(total)


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", ARCHS)
def test_flops_match_xla(arch, kind):
    lowered, compiled, dots = _jax_costs(arch, kind)
    cfg = get_config(arch, smoke=True).replace(compute_dtype="float32")
    got = dryrun.count_flops(cfg, ShapeConfig("x", kind, SMOKE[1], SMOKE[0]),
                             make_host_mesh())
    assert 0.99 <= got["products"] / dots <= 1.0, (got["products"], dots)
    total = got["products"] + got["elementwise"]
    assert BAND[0] <= total / lowered <= BAND[1], (total, lowered)
    if arch in COMPILED_BAND:
        assert BAND[0] <= total / compiled <= BAND[1], (total, compiled)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen2-moe-a2.7b",
                                  "mamba2-1.3b", "zamba2-7b",
                                  "whisper-medium"])
def test_depth_probe_is_exact(arch):
    cfg = get_config(arch, smoke=True)
    cfg = cfg.replace(num_layers=6, **({"encoder_layers": 6}
                                       if cfg.family == "encdec" else {}))
    if cfg.family == "hybrid":
        cfg = cfg.replace(shared_attn_every=2)
    shape, mesh = ShapeConfig("x", "train", 32, 2), make_host_mesh()
    acc = dryrun.account(cfg, shape, mesh)
    direct = dryrun.count_flops(cfg, shape, mesh)
    assert acc["product_flops"] == direct["products"]
    assert acc["flops"] == direct["products"] + direct["elementwise"]
    assert acc["probe_depths"] != [acc["full_depth_units"]] * 2


def _jx_bytes(decls_or_batch, specs, mesh, dtype=None):
    total = 0
    for x, s in zip(jax.tree.leaves(decls_or_batch,
                                    is_leaf=lambda d: hasattr(d, "axes")),
                    jax.tree.leaves(specs,
                                    is_leaf=lambda p: isinstance(p, JP))):
        n = jnp.dtype(dtype or x.dtype).itemsize
        for i, dim in enumerate(x.shape):
            ax = s[i] if i < len(s) else None
            assert dim % jx_sh._axis_size(mesh, ax) == 0
            n *= dim // jx_sh._axis_size(mesh, ax)
        total += n
    return total


def _fake(shape, names):
    class FakeMesh:
        axis_names = names

        class devices:
            pass
    FakeMesh.devices.shape = shape
    return FakeMesh()


@pytest.mark.parametrize("mesh", [((16, 16), ("data", "model")),
                                  ((2, 16, 16), ("pod", "data", "model"))],
                         ids=["single", "multi"])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "kimi-k2-1t-a32b",
                                  "zamba2-7b", "whisper-medium",
                                  "qwen2-vl-2b", "mamba2-1.3b"])
def test_argument_bytes_equal_jaxs_physical_specs(arch, mesh):
    fm = _fake(*mesh)
    jcfg, cfg = jx_get_config(arch), get_config(arch)
    jm = jx_build(jcfg)
    rules = jx_sh.make_rules(jcfg, fm)
    for shp in dryrun.applicable_shapes(cfg):
        spec = jm.input_specs(shp)
        want = _jx_bytes(jm.decls, jx_sh.physical_specs(jm.decls, jcfg, fm),
                         fm, jnp.dtype(jcfg.param_dtype))
        bspecs = jax.tree.map(
            lambda s, b: jx_sh.enforce_divisible(
                jx_sh.resolve_spec(s, rules), b.shape, fm),
            spec["batch_specs"], spec["batch"],
            is_leaf=lambda x: isinstance(x, JP))
        want += _jx_bytes(spec["batch"], bspecs, fm)
        if shp.kind == "train":
            od = jx_get_optimizer(jcfg).state_decls(jm.decls)
            want += _jx_bytes(od, jx_sh.physical_specs(od, jcfg, fm), fm)
        if shp.kind == "decode":
            cd = spec["cache_decls"]
            want += _jx_bytes(cd, jx_sh.physical_specs(cd, jcfg, fm), fm)
        got = dryrun.memory(cfg, shp, AbstractMesh(*mesh))
        assert got["argument_bytes"] == want, shp.name
        assert dryrun.memory(cfg, shp, fm)["argument_bytes"] == want


def _jax_run_cell_keys():
    """The keys of the dict ``run_cell`` of the JAX package's dry-run
    returns, nested dicts included (read from its source: importing it
    forces 512 host devices)."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "run_cell")
    res = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", None) == "res")

    def keys(d):
        return {k.value: (keys(v) if isinstance(v, ast.Dict) else None)
                for k, v in zip(d.keys, d.values) if k is not None}
    return keys(res)


def _has_keys(got, want, where=""):
    for k, sub in want.items():
        assert k in got, f"{where}{k}"
        if sub:
            _has_keys(got[k], sub, f"{where}{k}.")


def test_json_has_jaxs_keys_and_nulls_what_only_xla_gives(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(dryrun, "ART_DIR", tmp_path)
    assert dryrun.main(["--arch", "whisper-medium", "--shape", "decode_32k",
                        "--shape", "long_500k", "--mesh", "single"]) == 0
    res = json.loads((tmp_path / "single" /
                      "whisper-medium__decode_32k.json").read_text())
    _has_keys(res, _jax_run_cell_keys())
    assert res["params_total"] == dryrun.param_count(
        dryrun.build(get_config("whisper-medium")).decls)
    assert res["cost"]["flops_per_device"] > 0
    assert res["memory"]["argument_bytes"] > 0
    for k in ("t_compile_s",):
        assert res[k] is None
    # peak and temp bytes come from the traced step (JAX's identity peak =
    # argument + temp kept), transcendentals from the FLOP trace
    mem = res["memory"]
    assert mem["peak_device_bytes"] > mem["argument_bytes"] > 0
    assert mem["peak_device_bytes"] - mem["temp_bytes"] == \
        mem["argument_bytes"]
    assert res["cost"]["transcendentals"] > 0
    for k in ("bytes_per_device", "raw_full_flops_scanned"):
        assert res["cost"][k] is None
    # every family's collective bytes are counted (the encoder-decoder's
    # since slice 14)
    assert res["cost"]["collective_bytes_per_device"] >= 0
    assert all(v >= 0 for v in res["cost"]["per_op"].values())
    skipped = json.loads((tmp_path / "single" /
                          "whisper-medium__long_500k.json").read_text())
    assert skipped["skipped"] and skipped["reason"] == \
        "long_500k needs sub-quadratic attention"


def test_flash_attention_on_meta_traces_the_plain_version():
    q = torch.empty(2, 40, 4, 16, device="meta", requires_grad=True)
    k = torch.empty(2, 40, 2, 16, device="meta", requires_grad=True)
    v = torch.empty(2, 40, 2, 16, device="meta", requires_grad=True)
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v)
    assert out.device.type == "meta" and out.shape == q.shape
    assert out.grad_fn is not None and \
        "FlashAttention" not in type(out.grad_fn).__name__
    dq, dk, dv = torch.autograd.grad(out.sum(), (q, k, v))
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert fa.flash_attention.launches == before
    # the same function as the plain version's on the CPU
    x = torch.randn(1, 9, 2, 8)
    assert torch.equal(fa.flash_attention(x, x, x),
                       flash_attention_ref(x, x, x))
    with pytest.raises(ValueError, match="cpu or cuda"):
        fa._forward(q, k, v, True, False)


def test_new_modules_are_walked_and_import_no_jax():
    code = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"modules": names,
                  "leaked": sorted(m for m in sys.modules
                                   if m.split(".")[0] in ("jax", "repro"))}))
"""
    proc = subprocess.run([sys.executable, "-c", code], text=True,
                          capture_output=True, timeout=300, cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("train.compression", "distributed.pp",
                 "distributed.sharding", "launch.dryrun"):
        assert f"repro_torch.{name}" in got["modules"]
    assert got["leaked"] == []
