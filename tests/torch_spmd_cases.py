"""Shared by the tests of the zoo's DTensor route (``models/spmd.py``):
the reduced configs of each family, the one-device step's dot FLOPs, the
dry-run record's checks on a (2, 2) fake mesh, and the job a 4-rank gloo
group runs to hold the DTensor route's values against the plain route's.

Not a test file: ``test_torch_dryrun_families*.py`` and
``test_torch_spmd_parity_*.py`` import it, and the gloo group's spawned
ranks import :func:`parity_job` from it by name."""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import distribute_tensor

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun
from repro_torch.launch import sharding as SH
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import fake_world, make_debug_mesh
from repro_torch.launch.steps import make_decode_step, make_optimizer, make_prefill_step, make_train_step
from repro_torch.models import spmd
from repro_torch.models.model_zoo import build_model, make_backbone
from repro_torch.roofline.trace_analysis import TraceCounter

FAMILIES = {
    "dense": "phi4-mini-3.8b",
    "moe": "granite-moe-3b-a800m",
    "mla": "deepseek-v2-236b",
    "vlm": "qwen2-vl-72b",
    "ssm": "mamba2-370m",
    "hybrid": "zamba2-1.2b",
    "audio": "seamless-m4t-large-v2",
}

# 4 × per-device / one-device dot FLOPs: the split is exact but for the
# regions every device repeats by design (the MoE router, MLA's shared rope
# key, the SSM decode's one-token recurrence with every head), each < 3%
SPLIT_BOUNDS = (0.99, 1.03)


def shape_of(kind: str, seq: int = 32, batch: int = 4) -> InputShape:
    """The tests' step: batch 4, 32 tokens (a decode's cache of 32 slots)."""
    return InputShape(f"{kind}_t", seq, batch, kind)


def plain_dot_flops(cfg, shape) -> float:
    """The one-device step's dot FLOPs (fake CPU tensors, the trace
    counter)."""
    model = build_model(cfg)
    with FakeTensorMode():
        module = make_backbone(cfg, "cpu")
        if shape.kind == "train":
            tx = make_optimizer(cfg)
            step = make_train_step(model, tx)
            args = (module, tx.init(list(module.parameters())),
                    SP.zeros_like_spec(SP.train_specs(cfg, shape), "cpu"))
        elif shape.kind == "prefill":
            step = make_prefill_step(model)
            args = (module, SP.zeros_like_spec(SP.prefill_specs(cfg, shape), "cpu"))
        else:
            cache = model.cache_shapes(shape.global_batch, shape.seq_len)
            step = make_decode_step(model)
            args = (module, SP.zeros_like_spec(cache, "cpu"),
                    SP.zeros_like_spec(SP.decode_specs(cfg, shape), "cpu"))
        with TraceCounter() as counter:
            step(*args)
    return counter.cost.dot_flops


def debug_record(family: str, kind: str, seq: int = 32, batch: int = 4):
    """(the family's reduced config, its full-depth dry-run record on a
    (2, 2) fake mesh)."""
    arch = FAMILIES[family]
    cfg = get_config(arch).reduced()
    with fake_world(4):
        rec = dryrun.record(cfg, shape_of(kind, seq, batch), make_debug_mesh((2, 2)), arch=arch,
                            full_depth=True)
    return cfg, rec


def check_record(family: str, kind: str) -> None:
    """The family's debug record: the reference's parameter count, positive
    counts, a per-device dot-FLOP count within ``SPLIT_BOUNDS`` of the
    one-device step's / 4, and a row ``roofline_table.summarize`` reads."""
    import jax

    from benchmarks.roofline_table import summarize
    from repro.configs import get_config as ref_get
    from repro.models.model_zoo import build_model as ref_build

    cfg, rec = debug_record(family, kind)
    ref = ref_build(ref_get(rec["arch"]).reduced()).param_shapes()
    assert rec["num_params"] == sum(int(l.size) for l in jax.tree_util.tree_leaves(ref))
    assert rec["mesh"] == "2x2" and rec["kind"] == kind
    ha = rec["hlo_analysis"]
    assert ha["dot_flops"] > 0 and ha["traffic_bytes"] > 0
    split = 4 * ha["dot_flops"] / plain_dot_flops(cfg, shape_of(kind))
    assert SPLIT_BOUNDS[0] <= split <= SPLIT_BOUNDS[1], split
    assert ha["kernel_calls"] == {}  # fake CPU tensors: the plain route
    assert rec["roofline"]["useful_flops_ratio"] > 0
    assert rec["memory_analysis"]["argument_size_in_bytes"] > 0
    assert summarize({**rec, "shape": kind})["bottleneck"] in ("compute", "memory", "collective")


# ------------------------------------------------------------ gloo parity --
# name → (arch, config changes, mesh shape, policy); activations in f32 so the
# two routes agree to f32 rounding
CASES = {
    "dense": ("phi4-mini-3.8b", {}, (2, 2), {}),
    "dense-grouped-pin": ("phi4-mini-3.8b", dict(num_heads=8, num_kv_heads=2, shard_attn_heads=True),
                          (2, 2), {}),
    "dense-fsdp-embed": ("phi4-mini-3.8b", {}, (2, 2),
                         dict(fsdp_only_paths=("blocks",), embed_single_axis=True)),
    "dense-pods": ("phi4-mini-3.8b", {}, (2, 1, 2), {}),
    "moe": ("granite-moe-3b-a800m", {}, (2, 2), {}),
    "moe-whole-experts": ("granite-moe-3b-a800m", dict(num_experts=3), (2, 2), {}),
    "moe-pods": ("granite-moe-3b-a800m", {}, (2, 1, 2), {}),
    "mla": ("deepseek-v2-236b", {}, (2, 2), {}),
    "vlm": ("qwen2-vl-72b", {}, (2, 2), {}),
    "ssm": ("mamba2-370m", {}, (2, 2), {}),
    "ssm-pin": ("mamba2-370m", dict(shard_ssm_heads=True), (2, 2), {}),
    "hybrid": ("zamba2-1.2b", {}, (2, 2), {}),
    "audio": ("seamless-m4t-large-v2", {}, (2, 2), {}),
}
CACHE_LEN = 32
WRITE_SLOT = 21  # on the second half of a cache whose slots split over data


def case_config(name: str):
    arch, changes, _, _ = CASES[name]
    cfg = dataclasses.replace(get_config(arch).reduced(), activation_dtype="float32")
    moe = {k: v for k, v in changes.items() if k == "num_experts"}
    rest = {k: v for k, v in changes.items() if k != "num_experts"}
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
    return dataclasses.replace(cfg, **rest)


def _batch(cfg, specs, rng):
    out = {}
    for key, s in specs.items():
        if s.dtype.is_floating_point:
            out[key] = torch.from_numpy(rng.standard_normal(s.shape).astype(np.float32)).to(s.dtype)
        elif key == "pos":
            out[key] = torch.full(s.shape, WRITE_SLOT, dtype=s.dtype)
        else:
            out[key] = torch.from_numpy(rng.integers(0, cfg.vocab_size, s.shape).astype(np.int32))
    return out


def _cache(tree, rng):
    """A filled cache: float leaves f32 (the bf16 leaves too, so a write is
    compared at f32), stored positions +1 in [0, WRITE_SLOT], every write
    index at WRITE_SLOT."""
    if isinstance(tree, dict):
        return {k: _cache(v, rng) for k, v in tree.items()}
    if tree.dtype.is_floating_point:
        return torch.from_numpy(np.asarray(0.5 * rng.standard_normal(tree.shape), dtype=np.float32))
    if len(tree.shape) and tree.shape[-1] == CACHE_LEN:
        return torch.from_numpy(rng.integers(0, WRITE_SLOT + 1, tree.shape).astype(np.int32))
    return torch.full(tree.shape, WRITE_SLOT, dtype=tree.dtype)


def distribute_module(module, shapes_tree, mesh, **policy):
    """``module`` with every parameter a DTensor on ``mesh``, placed by its
    stacked leaf's spec (``sharding.module_specs``); in place. Every rank
    holds the same tensors (one seed), so each keeps its own shard and
    nothing is sent."""
    specs = SH.module_specs(module, shapes_tree, mesh, **policy)
    SH.replace_parameters(module, lambda name, p: distribute_tensor(
        p.detach(), mesh, SH.placements(specs[name], mesh), src_data_rank=None))
    return module


def distribute_tree(tree, spec_tree, mesh):
    """A nested dict of tensors as DTensors on ``mesh``, placed by the spec
    tree's specs (``batch_specs``, ``cache_specs``); every rank holds the
    same tensors."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, spec_tree[k], mesh) for k, v in tree.items()}
    return distribute_tensor(tree, mesh, SH.placements(spec_tree, mesh), src_data_rank=None)


def _full(t):
    if isinstance(t, dict):
        return {k: _full(v) for k, v in t.items()}
    return t.full_tensor() if spmd.is_dtensor(t) else t


def _err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}" if path else k)
    else:
        yield path, tree


def parity_job(rank, group, pairs):
    """On each rank of a 4-rank group: for each (case, kind) of ``pairs``,
    the DTensor step on the case's mesh, and on rank 0 the plain step on
    the same inputs (numpy, seed 0). Rank 0 returns {(case, kind):
    numbers}, the others {}: train (loss plain, loss DTensor, [(param, max
    |Δ grad|, max |grad|)]), train-micro (``make_train_step`` at 2
    microbatches: the two losses); prefill / decode (max |Δ logits|, max
    |logits|), decode adding {cache leaf: (max |Δ|, max |value|)} after the
    step."""
    del group
    lead = rank == 0
    out, built, meshes = {}, {}, {}
    for name, kind in pairs:
        if name not in built:
            _, _, mesh_shape, policy = CASES[name]
            if mesh_shape not in meshes:  # a mesh's groups are made once
                axes = ("data", "model") if len(mesh_shape) == 2 else ("pod", "data", "model")
                meshes[mesh_shape] = torch.distributed.device_mesh.init_device_mesh(
                    "cpu", mesh_shape, mesh_dim_names=axes)
            mesh = meshes[mesh_shape]
            cfg = case_config(name)
            model = build_model(cfg)
            module = model.init(torch.Generator().manual_seed(0))
            placed = distribute_module(copy.deepcopy(module), model.param_shapes(), mesh, **policy)
            built[name] = mesh, cfg, model, module, placed
        mesh, cfg, model, module, placed = built[name]
        rng = np.random.default_rng(0)
        shape = shape_of(kind.split("-")[0])
        if kind == "train":
            specs = SP.train_specs(cfg, shape)
            batch = _batch(cfg, specs, rng)
            dbatch = distribute_tree(batch, SH.batch_specs(specs, mesh), mesh)
            with spmd.spmd_scope(next(placed.parameters())):
                dloss = model.loss_fn(placed, dbatch)
                dgrads = torch.autograd.grad(dloss, list(placed.parameters()),
                                             materialize_grads=True, allow_unused=True)
            dloss, dgrads = float(_full(dloss.detach())), [_full(g) for g in dgrads]
            if lead:
                loss = model.loss_fn(module, batch)
                grads = torch.autograd.grad(loss, list(module.parameters()), materialize_grads=True,
                                            allow_unused=True)
                names_ = [n for n, _ in module.named_parameters()]
                out[(name, kind)] = (
                    float(loss), dloss,
                    [(n, _err(dg, g), float(g.abs().max())) for n, dg, g in zip(names_, dgrads, grads)],
                )
        elif kind == "train-micro":  # make_train_step at 2 microbatches, on copies
            specs = SP.train_specs(cfg, shape)
            batch = _batch(cfg, specs, rng)
            runs = [(copy.deepcopy(placed), distribute_tree(batch, SH.batch_specs(specs, mesh), mesh))]
            if lead:
                runs.append((copy.deepcopy(module), batch))
            losses = []
            for params, inputs in runs:
                tx = make_optimizer(cfg)
                step = make_train_step(model, tx, num_microbatches=2)
                losses.append(float(_full(step(params, tx.init(list(params.parameters())), inputs))))
            if lead:
                out[(name, kind)] = (losses[1], losses[0], [])
        elif kind == "prefill":
            specs = SP.prefill_specs(cfg, shape)
            batch = _batch(cfg, specs, rng)
            dlogits = _full(model.prefill_fn(placed, distribute_tree(batch, SH.batch_specs(specs, mesh), mesh)))
            if lead:
                logits = model.prefill_fn(module, batch)
                out[(name, kind)] = (_err(dlogits, logits), float(logits.abs().max()))
        else:
            specs = SP.decode_specs(cfg, shape)
            batch = _batch(cfg, specs, rng)
            tree = model.cache_shapes(shape.global_batch, CACHE_LEN)
            cache = _cache(tree, rng)
            dcache = distribute_tree(copy.deepcopy(cache), SH.cache_specs(tree, mesh), mesh)
            dbatch = distribute_tree(batch, SH.batch_specs(specs, mesh), mesh)
            dlogits, dcache = model.decode_fn(placed, dcache, dbatch)
            dlogits, got = _full(dlogits), dict(_leaves(_full(dcache)))
            if lead:
                logits, cache = model.decode_fn(module, cache, batch)
                caches = {p: (_err(got[p], v), float(v.abs().max())) for p, v in _leaves(cache)}
                out[(name, kind)] = (_err(dlogits, logits), float(logits.abs().max()), caches)
    return out


def check_parity(result, kind, tol=1e-5):
    """The DTensor step's numbers equal the plain step's to ``tol`` of the
    largest value (losses and logits, caches, each parameter's gradient
    to 2 × ``tol`` of its largest entry: a backward sums more terms);
    integer cache leaves exactly."""
    if kind in ("train", "train-micro"):
        loss, dloss, grads = result
        assert math.isfinite(loss) and abs(dloss - loss) <= tol * max(1.0, abs(loss)), (loss, dloss)
        for name, err, big in grads:
            assert err <= 2 * tol * max(big, 1e-6), (name, err, big)
        return
    err, big = result[:2]
    assert err <= tol * max(1.0, big), (err, big)
    if kind == "decode":
        for leaf, (err, big) in result[2].items():
            assert err <= tol * max(1.0, big), (leaf, err, big)


# -------------------------------------------------------- reference's HLO --
# the reference's dry-run core (repro.launch.dryrun.dryrun_pair's lowering)
# on a (2, 2) host mesh: argv archs kinds seq batch → one JSON line per pair
REFERENCE = r'''
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
from repro.configs import get_config
from repro.configs.base import InputShape
from repro.launch import sharding as SH
from repro.launch import specs as SP
from repro.launch.mesh import make_debug_mesh
from repro.launch.steps import (make_decode_step, make_optimizer, make_prefill_step,
                                make_train_step, opt_state_shapes)
from repro.models.model_zoo import build_model
from repro.roofline.hlo_analysis import analyze_hlo_text

def lower(cfg, kind, mesh):
    shape = InputShape(kind + "_t", int(sys.argv[3]), int(sys.argv[4]), kind)
    model = build_model(cfg)
    ps = model.param_shapes()
    psh = SH.shard_params(ps, mesh)
    if kind == "train":
        b = SP.train_specs(cfg, shape)
        tx = make_optimizer(cfg)
        opt = opt_state_shapes(tx, ps)
        step = jax.jit(make_train_step(model, tx),
                       in_shardings=(psh, SH.shard_params(opt, mesh), SH.shard_batch(b, mesh)),
                       out_shardings=(psh, SH.shard_params(opt, mesh), SH.replicated(mesh)),
                       donate_argnums=(0, 1))
        return step.lower(ps, opt, b)
    if kind == "prefill":
        b = SP.prefill_specs(cfg, shape)
        return jax.jit(make_prefill_step(model), in_shardings=(psh, SH.shard_batch(b, mesh))).lower(ps, b)
    b = SP.decode_specs(cfg, shape)
    c = model.cache_shapes(shape.global_batch, shape.seq_len)
    csh = SH.shard_cache(c, mesh)
    step = jax.jit(make_decode_step(model), in_shardings=(psh, csh, SH.shard_batch(b, mesh)),
                   out_shardings=(SH.replicated(mesh), csh), donate_argnums=(1,))
    return step.lower(ps, c, b)

mesh = make_debug_mesh((2, 2))
for arch in sys.argv[1].split(","):
    for kind in sys.argv[2].split(","):
        with mesh:
            hlo = lower(get_config(arch).reduced(), kind, mesh).compile().as_text()
        cost = analyze_hlo_text(hlo).as_dict()
        print(json.dumps({"arch": arch, "kind": kind, "dot_flops": cost["dot_flops"],
                          "collective_counts": cost["collective_counts"],
                          "collective_bytes": cost["total_collective_bytes"]}), flush=True)
'''

# the port's per-device dot FLOPs / the reference's, on every pair: the port
# splits attention heads and SSD heads over ``model`` where XLA's own choice
# may repeat them, so it may count a few percent less
REFERENCE_BOUNDS = (0.94, 1.06)
# the port's per-device collective bytes / the reference's: the port gathers
# every weight over ``data`` each step (FSDP) and moves MoE experts to their
# ``model`` devices, where XLA may keep a weight in place and reduce the
# (small) activations instead; 1.0-7.2x on these pairs
COLLECTIVE_BYTES_BOUND = 8.0


def start_reference(kinds, tmp, families=tuple(FAMILIES), seq=32, batch=4):
    """The reference's counts for ``families`` at ``kinds``, in a JAX
    subprocess on 4 forced host devices (started, not waited for)."""
    root = Path(__file__).resolve().parents[1]
    script = Path(tmp) / "reference.py"
    script.write_text(REFERENCE)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(root / "src") + os.pathsep + str(root)}
    return subprocess.Popen(
        [sys.executable, str(script), ",".join(FAMILIES[f] for f in families), ",".join(kinds),
         str(seq), str(batch)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=root,
    )


def both_counts(kinds, tmp, timeout=240, families=tuple(FAMILIES), seq=32, batch=4):
    """({(arch, kind): the reference's counts}, {(family, kind): the port's
    record}) for ``families`` at ``kinds``: the reference's subprocess runs
    while the port traces."""
    proc = start_reference(kinds, tmp, families, seq, batch)
    try:
        port = {(f, k): debug_record(f, k, seq, batch)[1] for f in families for k in kinds}
        out, err = proc.communicate(timeout=timeout)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    rows = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    return {(r["arch"], r["kind"]): r for r in rows}, port


def check_against_reference(counts, family, kind) -> None:
    """The port's per-device dot FLOPs within ``REFERENCE_BOUNDS`` of the
    reference's, its collective bytes within ``COLLECTIVE_BYTES_BOUND`` of
    them, and both steps moving data with all-gathers (the data axes'
    gathers) and all-reduces (pending sums)."""
    ref, port = counts
    rec, want = port[(family, kind)], ref[(FAMILIES[family], kind)]
    ratio = rec["hlo_analysis"]["dot_flops"] / want["dot_flops"]
    assert REFERENCE_BOUNDS[0] <= ratio <= REFERENCE_BOUNDS[1], (ratio, want["dot_flops"])
    moved = rec["collectives"]["total_bytes"] / want["collective_bytes"]
    assert 0 < moved <= COLLECTIVE_BYTES_BOUND, moved
    kinds = {k for k, n in rec["collectives"]["counts"].items() if n}
    ref_kinds = {k for k, n in want["collective_counts"].items() if n}
    assert kinds <= set(want["collective_counts"]), kinds
    assert {"all-gather", "all-reduce"} <= kinds & ref_kinds, (kinds, ref_kinds)


if __name__ == "__main__":
    # PYTHONPATH=src:tests python tests/torch_spmd_cases.py [--seq S --batch B --families moe ...]:
    # the table the reference tests hold (at their 32 × 4 by default)
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--families", nargs="*", default=list(FAMILIES))
    ap.add_argument("--kinds", nargs="*", default=["train", "prefill", "decode"])
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        ref, port = both_counts(args.kinds, tmp, 1800, args.families, args.seq, args.batch)
    print("family kind | dot FLOPs port / reference | collective bytes port / reference | "
          "collectives port / reference")
    for (family, kind), rec in port.items():
        want = ref[(FAMILIES[family], kind)]
        print(f"{family} {kind} | {rec['hlo_analysis']['dot_flops']:.0f} / {want['dot_flops']:.0f} = "
              f"{rec['hlo_analysis']['dot_flops'] / want['dot_flops']:.4f} | "
              f"{rec['collectives']['total_bytes']:.0f} / {want['collective_bytes']:.0f} = "
              f"{rec['collectives']['total_bytes'] / want['collective_bytes']:.2f} | "
              f"{rec['collectives']['total_count']} / {sum(want['collective_counts'].values())}")
