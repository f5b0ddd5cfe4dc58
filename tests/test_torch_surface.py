"""PyTorch port, its public surface against the JAX package's, module by
module, and the parity of the names that close it.

The walk reads every module of ``dmft_lanc_ed_tpu`` with ``ast`` (no JAX
import for the walk) and takes each public top-level name (functions,
classes, assigned names, and the relative re-exports of a package's
``__init__``) and each public method or property of a public class. The
port's module of the same path must have it, or the name stands in
``NOT_CARRIED`` with its reason (ROADMAP.md, "What is not carried over").
Every entry there must still exist in the JAX package and still be absent
from the port, so the list cannot go stale.

Tolerances, each with its origin:
- ``make_matvec``: the f64 ELL apply, 1e-12 x max|y| against the JAX
  package's (tests/test_torch_backends.py's applies);
- ``matvec_dense_fast(_flat)``: 1e-12 x max|y| on a plain sector, where the
  two packages' f32 products agree bit for bit; 1e-7 x max|y| on a Jx/Jp
  sector, where the f32 hop products of the two BLAS libraries sum their
  nonzeros in different orders, each within that of the f64 apply.
"""
import ast
import importlib
import pathlib

import numpy as np
import pytest
import torch

import dmft_lanc_ed_tpu as ed
import dmft_lanc_ed_tpu_torch as pt
from dmft_lanc_ed_tpu.ops import dense as jx_dense
from dmft_lanc_ed_tpu.ops import matvec as jx_matvec
from dmft_lanc_ed_tpu_torch.ops import dense as pt_dense
from dmft_lanc_ed_tpu_torch.ops import factory as pt_factory
from dmft_lanc_ed_tpu_torch.ops import matvec as pt_matvec

JAX_ROOT = pathlib.Path(ed.__file__).parent

_TPU_BUDGET = "a Mosaic VMEM budget; the port sizes by device bytes"
_BATCH_FLOOR = ("a fixed batch floor for the TPU's remote compiler; the "
                "port batches what it has")
_BF16_PAIR = ("the TPU kernels' two-part bf16 slab split; the port splits "
              "the slabs in three where a kernel needs them (ops/bf16x3.py)")
_HOST_PIN = ("pins JAX dispatch to XLA's CPU backend; the port's host math "
             "is numpy or CPU torch already")
_PADDED_HALF = ("no caller in the port; the padded geometry, diagonal "
                "factors and slabs are the op's padded half, ``op.pop``")

# (module path under the package, name) -> why the port does not carry it
NOT_CARRIED = {
    ("gf", "BucketedOp"): "pow2 GF bucketing, TPU compiler only",
    ("gf", "unwrap_op"): "unwraps BucketedOp, which the port does not carry",
    ("ops.batched", "B_FIXED"): _BATCH_FLOOR,
    ("ops.batched", "transpose_op"): (
        "orientation transpose of bucket ops for the TPU's layouts; the "
        "port's buckets take one orientation"),
    ("ops.blocksparse", "VMEM_LIMIT"): _TPU_BUDGET,
    ("ops.blocksparse", "VMEM_RESIDENT_BUDGET"): _TPU_BUDGET,
    ("ops.blocksparse", "RUNS_VMEM_LIMIT"): _TPU_BUDGET,
    ("ops.blocksparse", "RUNS_VMEM_RESIDENT"): _TPU_BUDGET,
    ("ops.blocksparse", "BlockSparseSectorOp.dw_hi"): _BF16_PAIR,
    ("ops.blocksparse", "BlockSparseSectorOp.dw_lo"): _BF16_PAIR,
    ("ops.blocksparse", "BlockSparseSectorOp.up_hi"): _BF16_PAIR,
    ("ops.blocksparse", "BlockSparseSectorOp.up_lo"): _BF16_PAIR,
    **{("ops.blocksparse", f"BlockSparseSectorOp.{f}"): _PADDED_HALF
       for f in ("w_dw", "d_dw", "w_up", "d_up", "diag_a", "diag_b",
                 "dw_f32", "up_f32")},
    ("ops.bs_chain", "CHAIN_VMEM_BUDGET"): _TPU_BUDGET,
    ("ops.bs_chain", "CHAIN_VMEM_LIMIT"): _TPU_BUDGET,
    ("ops.bs_chain", "GF_CHAIN_BATCH"): _BATCH_FLOOR,
    ("ops.factory", "ND_APPLY"): (
        "no caller in the port; the sharded path keeps its own map "
        "(parallel/production._ND_APPLY)"),
    ("ops.matvec", "apply_h_jit"): "a jax.jit wrapper of apply_h",
    ("native", "encode_runs"): (
        "no caller in the port, nor in the JAX package outside its own "
        "test"),
    ("parallel.bs_sharded", "host_polish"): (
        "the port's second stage, the mixed top-off and f64 polish over the "
        "sharded dense operator, replaces it"),
    ("parallel.production", "ShardedSectorOp.sharding"): (
        "a jax NamedSharding; a port rank holds its own rows (DwMesh)"),
    ("parallel.production", "ShardedDirectOp.nnz"): (
        "no caller in the port; the counters read ShardedSectorOp.nnz"),
    ("utils", "host_device"): _HOST_PIN,
    ("utils", "on_host"): _HOST_PIN,
}


def _modules():
    """Module paths under the package ("" for the package itself)."""
    out = []
    for path in sorted(JAX_ROOT.rglob("*.py")):
        parts = [p for p in path.relative_to(JAX_ROOT).with_suffix("").parts
                 if p != "__init__"]
        out.append((".".join(parts), path))
    return out


MODULES = dict(_modules())


def _public(path: pathlib.Path) -> dict:
    """{public top-level name: [public methods] or None} of one module."""
    tree = ast.parse(path.read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = None
        elif isinstance(node, ast.ClassDef):
            out[node.name] = [
                n.name for n in node.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                and not n.name.startswith("_")]
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            out.update({t.id: None for t in targets
                        if isinstance(t, ast.Name)})
        elif (isinstance(node, ast.ImportFrom) and node.level > 0
              and path.name == "__init__.py"):
            out.update({(a.asname or a.name): None for a in node.names})
    return {k: v for k, v in out.items() if not k.startswith("_")}


def _port(mod: str):
    return importlib.import_module(
        ".".join(["dmft_lanc_ed_tpu_torch"] + ([mod] if mod else [])))


def _has(obj, dotted: str) -> bool:
    for part in dotted.split("."):
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


@pytest.mark.parametrize("mod", list(MODULES), ids=lambda m: m or "package")
def test_port_module_carries_every_public_name(mod):
    port = _port(mod)
    missing = []
    for name, methods in _public(MODULES[mod]).items():
        if (mod, name) in NOT_CARRIED:          # its methods go with it
            continue
        for dotted in [name] + [f"{name}.{m}" for m in methods or []]:
            if (mod, dotted) not in NOT_CARRIED and not _has(port, dotted):
                missing.append(dotted)
    assert not missing, f"{mod or 'package'}: {missing}"


@pytest.mark.parametrize("mod,dotted", list(NOT_CARRIED),
                         ids=[f"{m}.{d}" for m, d in NOT_CARRIED])
def test_not_carried_entry_is_in_the_jax_package_only(mod, dotted):
    assert NOT_CARRIED[(mod, dotted)]
    name, _, method = dotted.partition(".")
    public = _public(MODULES[mod])
    assert name in public, (mod, dotted)
    assert not method or method in public[name], (mod, dotted)
    assert not _has(_port(mod), dotted), f"{mod}.{dotted} is carried"


def test_ops_reexports_are_their_modules_objects():
    from dmft_lanc_ed_tpu_torch import ops
    from dmft_lanc_ed_tpu_torch.ops import (apply_h, davidson_ground_state,
                                            lanczos_ground_state,
                                            lanczos_tridiag, make_matvec,
                                            matvec_flat, tridiag_eigh)
    from dmft_lanc_ed_tpu_torch.ops import davidson, lanczos, matvec
    names = set(_public(MODULES["ops"]))
    assert names == {"apply_h", "matvec_flat", "make_matvec",
                     "lanczos_tridiag", "tridiag_eigh",
                     "lanczos_ground_state", "davidson_ground_state"}
    home = {"apply_h": matvec, "matvec_flat": matvec, "make_matvec": matvec,
            "lanczos_tridiag": lanczos, "tridiag_eigh": lanczos,
            "lanczos_ground_state": lanczos,
            "davidson_ground_state": davidson}
    got = {"apply_h": apply_h, "matvec_flat": matvec_flat,
           "make_matvec": make_matvec, "lanczos_tridiag": lanczos_tridiag,
           "tridiag_eigh": tridiag_eigh,
           "lanczos_ground_state": lanczos_ground_state,
           "davidson_ground_state": davidson_ground_state}
    for name in names:
        assert getattr(ops, name) is getattr(home[name], name) is got[name]


SECTORS = {
    # tests/test_direct.py's models, nbath <= 5
    "normal": (dict(norb=1, nbath=5, uloc=(2.0,), xmu=0.1), (3, 3)),
    "jx_jp": (dict(norb=2, nbath=3, uloc=(2.0, 2.0), ust=1.0, jh=0.5,
                   jx=0.5, jp=0.5), (4, 4)),
    "phonon": (dict(norb=1, nbath=3, uloc=(2.0,), nph=3, w0_ph=0.7,
                    g_ph=(0.3,), xmu=0.2), (2, 2)),
}


def _hamiltonians(name):
    """The same sector's Hamiltonian from each package, and its dim."""
    model, sqn = SECTORS[name]
    out = []
    for mod in (ed, pt):
        cfg = mod.EDConfig(**model)
        sec = mod.SectorTable(cfg).sector(mod.qn(*sqn))
        out.append((cfg, sec, mod.build_sector_hamiltonian(
            cfg, sec, np.zeros((1, 1, cfg.norb, cfg.norb)),
            mod.init_bath(cfg))))
    return out


@pytest.mark.parametrize("name", list(SECTORS))
def test_make_matvec_matches_jax(name):
    (_, jsec, jh), (_, _, h) = _hamiltonians(name)
    jmv = jx_matvec.make_matvec(jh)
    mv = pt_matvec.make_matvec(pt_matvec.ell_op(h, "cpu"))
    x = np.random.default_rng(11).standard_normal((2, jsec.dim))
    for xi in x:
        y_ref = np.asarray(jmv(xi))
        y = mv(torch.as_tensor(xi)).numpy()
        assert np.abs(y - y_ref).max() <= 1e-12 * np.abs(y_ref).max()


FAST_TOL = {"normal": 1e-12, "jx_jp": 1e-7}


@pytest.mark.parametrize("name", list(FAST_TOL))
def test_matvec_dense_fast_matches_jax(name):
    (jcfg, jsec, _), (cfg, sec, _) = _hamiltonians(name)
    hloc = np.zeros((1, 1, cfg.norb, cfg.norb))
    jop = jx_dense.build_dense_op(jcfg, jsec, hloc, ed.init_bath(jcfg))
    op = pt_dense.build_dense_op(cfg, sec, hloc, pt.init_bath(cfg), "cpu")
    x = np.random.default_rng(12).standard_normal((2, sec.dim))
    for xi in x:
        y_ref = np.asarray(jx_dense.matvec_dense_fast_flat(jop, xi))
        scale = np.abs(y_ref).max()
        y = pt_dense.matvec_dense_fast_flat(op, torch.as_tensor(xi))
        assert np.abs(y.numpy() - y_ref).max() <= FAST_TOL[name] * scale
        y64 = np.asarray(jx_dense.matvec_dense_flat(jop, xi))
        assert np.abs(y.numpy() - y64).max() <= 1e-7 * scale
        y_nd = pt_dense.matvec_dense_fast(
            op, torch.as_tensor(xi).reshape(op.vshape))
        assert torch.equal(y_nd.reshape(-1), y)
    assert not pt_factory.apply_is_exact(pt_dense.matvec_dense_fast_flat)
