"""The multi-pod dry-run: trace every (arch × input shape × mesh) step of the
zoo against the reference's production meshes, at full size, with nothing
allocated.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-370m --shape long_500k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes [--optimized]

Counterpart of ``repro.launch.dryrun``. The reference lowers and compiles
each step with ``jax.jit`` over ``ShapeDtypeStruct`` inputs on 512 forced
host devices and reads the partitioned HLO. Here one process holds rank 0
of a ``"fake"`` process group of the mesh's size (``launch.mesh.fake_world``;
collectives move nothing) and a ``DeviceMesh`` of the reference's shape.
The parameters (placed by ``launch.sharding.module_specs``), the optimizer
state, the batch (``launch.specs``) and the decode cache (``cache_shapes``
placed by ``cache_specs``) are DTensors over fake tensors (``FakeTensorMode``:
shapes and dtypes, no storage). The step (``make_train_step``,
``make_prefill_step`` or ``make_decode_step``) runs once under
``roofline.trace_analysis.TraceCounter``, which counts rank 0's local ops
and the redistributions' collectives.

Repeated blocks are traced at one and two blocks of each stack (every
other stack at one), and the difference is extended to the stack's length;
the lengths go in ``while_trip_counts``. ``dryrun_pair(..., full_depth=True)``
traces every layer instead (the tests hold the two equal).

The step traces the route its tensors' device picks: fake tensors sit on
the CPU, so this is the plain route (``"route": "plain"`` in the record),
not the kernels. Importing this module touches no process group and reads
no environment; the CLI never initialises CUDA (its last line says so).

The record has the reference's keys, so ``benchmarks/roofline_table.py``
reads it as it is: ``arch``, ``shape``, ``mesh``, ``multi_pod``, ``kind``,
``attn_window``, ``variant``, ``policy``, ``num_params``,
``model_flops_global``, ``hlo_analysis`` (the name kept: it holds the trace
counter's per-device counts, ``TraceCost.as_dict()``), ``collectives``
(bytes and counts by kind, and their totals), ``roofline`` (the port's
``roofline_terms`` on the H100, plus ``model_flops_per_device`` and
``useful_flops_ratio``), ``lower_s`` (the trace's seconds), ``total_s`` and
``memory_analysis``, whose ``argument_size_in_bytes`` and
``output_size_in_bytes`` are rank 0's shard bytes of the step's inputs and
outputs (a decode's cache and a train step's parameters and optimizer state
in both, as the reference donates them). The reference's ``compile_s``,
``cost_analysis`` (XLA's own counts), ``hlo_bytes_len`` and the memory
analysis's temp, generated-code, alias, host and serialized sizes have no
counterpart: nothing is compiled, and no temp peak is measured.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict, List, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor

from repro_torch.configs import INPUT_SHAPES, all_configs, get_config
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.launch import sharding as SH
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.launch.steps import (
    make_decode_step,
    make_optimizer,
    make_prefill_step,
    make_train_step,
    opt_state_shapes,
)
from repro_torch.models.model_zoo import build_model, make_backbone
from repro_torch.roofline.analysis import model_flops, roofline_terms
from repro_torch.roofline.trace_analysis import TraceCost, TraceCounter

LONG_CONTEXT_WINDOW = 4096  # sliding-window variant for dense archs at 500k
DEFAULT_OUT = "experiments/dryrun-torch"


def config_for(arch: str, shape: InputShape) -> ArchConfig:
    """The arch's config for a shape: at ``long_500k`` a non-subquadratic
    arch, and the hybrid's shared attention block, take the sliding window
    of ``LONG_CONTEXT_WINDOW`` (the reference's documented variant)."""
    cfg = get_config(arch)
    if shape.name == "long_500k" and not cfg.subquadratic:
        cfg = dataclasses.replace(cfg, attn_window=LONG_CONTEXT_WINDOW)
    if shape.name == "long_500k" and cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, attn_window=LONG_CONTEXT_WINDOW)
    return cfg


def _stride(shape) -> Tuple[int, ...]:
    out, acc = [], 1
    for n in reversed(tuple(shape)):
        out.append(acc)
        acc *= int(n)
    return tuple(reversed(out))


def fake_dtensor(shape, dtype: torch.dtype, spec, mesh) -> DTensor:
    """A DTensor of global ``shape`` placed by ``spec`` over a fake local
    shard (call under ``FakeTensorMode``)."""
    local = torch.zeros(SH.local_shape(tuple(shape), spec, mesh), dtype=dtype)
    return DTensor.from_local(
        local, mesh, SH.placements(spec, mesh), run_check=False,
        shape=torch.Size(shape), stride=_stride(shape),
    )


def _tree(specs, leaves, fn):
    if isinstance(leaves, dict):
        return {k: _tree(specs[k], v, fn) for k, v in leaves.items()}
    return fn(leaves, specs)


def _local_bytes(leaves, specs, mesh) -> int:
    if isinstance(leaves, dict):
        return sum(_local_bytes(v, specs[k], mesh) for k, v in leaves.items())
    return math.prod(SH.local_shape(tuple(leaves.shape), specs, mesh)) * leaves.dtype.itemsize


def place_backbone(cfg: ArchConfig, mesh, fsdp_only=(), embed_single_axis=False):
    """The family's backbone with every parameter a fake DTensor placed by
    its stacked leaf's spec (``launch.sharding.module_specs``)."""
    model = build_model(cfg)
    module = make_backbone(cfg, "meta")
    specs = SH.module_specs(module, model.param_shapes(), mesh, fsdp_only, embed_single_axis)
    SH.replace_parameters(
        module, lambda name, p: fake_dtensor(tuple(p.shape), p.dtype, specs[name], mesh)
    )
    return model, module


def _batch_specs(tree, mesh, both_axes: bool):
    if not both_axes:
        return SH.batch_specs(tree, mesh)
    n_dev = math.prod(SH.axis_sizes(mesh).values())
    axes = SH.axis_names(mesh)

    def one(_, leaf):
        if len(leaf.shape) and leaf.shape[0] % n_dev == 0:
            return (tuple(axes),) + (None,) * (len(leaf.shape) - 1)
        return SH.batch_spec(tuple(leaf.shape), mesh)

    return SH.map_tree(tree, one)


def trace_step(cfg: ArchConfig, shape: InputShape, mesh, policy: Dict[str, Any],
               cache_cfg: ArchConfig = None) -> TraceCost:
    """One step of ``cfg`` at ``shape`` on ``mesh`` under the trace counter
    (the process must hold rank 0 of a process group of the mesh's size).
    A decode's cache is ``cache_cfg``'s (default ``cfg``'s): a model of
    fewer blocks reads the first entries of a deeper model's stacked cache,
    placed as that model's are."""
    fsdp_only = tuple(policy.get("fsdp_only", ()))
    embed_single_axis = policy.get("embed_single_axis", False)
    both = policy.get("batch_both_axes", False)
    with FakeTensorMode():
        model, module = place_backbone(cfg, mesh, fsdp_only, embed_single_axis)

        def batch_of(tree):
            return _tree(_batch_specs(tree, mesh, both), tree,
                         lambda l, s: fake_dtensor(l.shape, l.dtype, s, mesh))

        if shape.kind == "train":
            batch = batch_of(SP.train_specs(cfg, shape))
            tx = make_optimizer(cfg)
            opt = tx.init(list(module.parameters()))
            step = make_train_step(model, tx, num_microbatches=policy.get("microbatches", 1))
            args = (module, opt, batch)
        elif shape.kind == "prefill":
            step, args = make_prefill_step(model), (module, batch_of(SP.prefill_specs(cfg, shape)))
        else:
            tree = build_model(cache_cfg or cfg).cache_shapes(shape.global_batch, shape.seq_len)
            cache = _tree(SH.cache_specs(tree, mesh), tree,
                          lambda l, s: fake_dtensor(l.shape, l.dtype, s, mesh))
            step = make_decode_step(model)
            args = (module, cache, batch_of(SP.decode_specs(cfg, shape)))
        with TraceCounter() as counter:
            step(*args)
    return counter.cost


def stack_variants(cfg: ArchConfig) -> Tuple[ArchConfig, List[Tuple[ArchConfig, int, int]]]:
    """(the config at the fewest blocks of each repeated stack, [(the config
    with one block more in stack i, the blocks stack i has beyond the
    first config's, stack i's length)]). zamba2's trailing stack has none
    in the first config; every other stack has one."""
    r = dataclasses.replace
    if cfg.family == "hybrid":
        every = cfg.hybrid_attn_every
        n_super, n_rest = divmod(cfg.num_layers, every)
        stacks = [(r(cfg, num_layers=2 * every), n_super - 1, n_super)]
        if n_rest:
            stacks.append((r(cfg, num_layers=every + 1), n_rest, n_rest))
        return r(cfg, num_layers=every), stacks
    if cfg.family == "audio":
        one = r(cfg, num_layers=1, encoder_layers=1)
        return one, [(r(one, encoder_layers=2), cfg.encoder_layers - 1, cfg.encoder_layers),
                     (r(one, num_layers=2), cfg.num_layers - 1, cfg.num_layers)]
    first = 2 if (cfg.family == "moe" and cfg.mla is not None) else 1  # deepseek's dense0
    length = cfg.num_layers - first + 1
    return r(cfg, num_layers=first), [(r(cfg, num_layers=first + 1), length - 1, length)]


def trace_pair(cfg: ArchConfig, shape: InputShape, mesh, policy: Dict[str, Any],
               full_depth: bool = False) -> TraceCost:
    """The step's per-device cost: traced at full depth, or at the fewest
    blocks plus, for each stack, its extra blocks × (the trace with one
    block more − the fewest-blocks trace)."""
    if full_depth:
        return trace_step(cfg, shape, mesh, policy)
    base_cfg, stacks = stack_variants(cfg)
    base = trace_step(base_cfg, shape, mesh, policy, cfg)
    terms = [(base, 1)]
    for var_cfg, extra, _ in stacks:
        if extra:
            more = trace_step(var_cfg, shape, mesh, policy, cfg)
            terms += [(more, extra), (base, -extra)]
    cost = TraceCost.combine(terms)
    cost.while_trip_counts = [length for _, _, length in stacks]
    return cost


def _memory(cfg, model, shape, mesh, policy) -> Dict[str, int]:
    """Rank 0's shard bytes of the step's inputs and outputs."""
    fsdp, embed1 = tuple(policy["fsdp_only"]), policy["embed_single_axis"]
    pshapes = model.param_shapes()
    pspecs = SH.param_specs(pshapes, mesh, fsdp, embed1)
    params = _local_bytes(pshapes, pspecs, mesh)
    both = policy["batch_both_axes"]
    if shape.kind == "train":
        opt = opt_state_shapes(make_optimizer(cfg), pshapes)[1]
        moments = sum(_local_bytes(v, pspecs, mesh) for k, v in opt.items() if k != "step")
        batch = SP.train_specs(cfg, shape)
        args = params + moments + 4 + _local_bytes(batch, _batch_specs(batch, mesh, both), mesh)
        return {"argument_size_in_bytes": args, "output_size_in_bytes": params + moments + 4 + 4}
    logits = SP.TensorSpec((shape.global_batch, cfg.vocab_size), torch.float32)
    out = _local_bytes(logits, SH.batch_spec(logits.shape, mesh), mesh)
    if shape.kind == "prefill":
        batch = SP.prefill_specs(cfg, shape)
        args = params + _local_bytes(batch, _batch_specs(batch, mesh, both), mesh)
        return {"argument_size_in_bytes": args, "output_size_in_bytes": out}
    batch = SP.decode_specs(cfg, shape)
    tree = model.cache_shapes(shape.global_batch, shape.seq_len)
    cache = _local_bytes(tree, SH.cache_specs(tree, mesh), mesh)
    args = params + cache + _local_bytes(batch, _batch_specs(batch, mesh, both), mesh)
    return {"argument_size_in_bytes": args, "output_size_in_bytes": out + cache}


def _collectives(cost: TraceCost) -> Dict[str, Any]:
    return {
        "bytes": dict(cost.collective_bytes),
        "counts": dict(cost.collective_counts),
        "total_bytes": cost.total_collective_bytes,
        "total_count": sum(cost.collective_counts.values()),
    }


def pair_config(arch: str, shape: InputShape, ssd_chunk: int = 0, shard_ssm_heads: bool = False,
                params_bf16: bool = False, shard_attn_heads: bool = False) -> ArchConfig:
    """:func:`config_for` with the policy's config knobs."""
    cfg = config_for(arch, shape)
    if ssd_chunk and cfg.ssm is not None:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, chunk=ssd_chunk))
    if shard_ssm_heads:
        cfg = dataclasses.replace(cfg, shard_ssm_heads=True)
    if shard_attn_heads:
        cfg = dataclasses.replace(cfg, shard_attn_heads=True)
    if params_bf16:
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    return cfg


def record(cfg: ArchConfig, shape: InputShape, mesh, *, arch: str, multi_pod: bool = False,
           collect_hlo: bool = True, lower_only: bool = False, microbatches: int = 1,
           fsdp_only: tuple = (), batch_both_axes: bool = False, embed_single_axis: bool = False,
           variant: str = "", full_depth: bool = False) -> Dict[str, Any]:
    """:func:`dryrun_pair`'s record for a config on a given mesh (the core
    the tests run on ``make_debug_mesh``)."""
    sizes = SH.axis_sizes(mesh)
    policy = {"microbatches": microbatches, "fsdp_only": list(fsdp_only),
              "batch_both_axes": batch_both_axes, "embed_single_axis": embed_single_axis}
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape.name, "mesh": "x".join(str(n) for n in sizes.values()),
        "multi_pod": multi_pod, "kind": shape.kind, "attn_window": cfg.attn_window,
        "variant": variant, "policy": policy, "route": "plain",
    }
    t0 = time.time()
    model = build_model(cfg)
    rec["num_params"] = sum(math.prod(s.shape) for s in SP.leaves(model.param_shapes()))
    cost = trace_pair(cfg, shape, mesh, policy, full_depth)
    rec["lower_s"] = round(time.time() - t0, 2)
    if lower_only:
        return rec
    rec["memory_analysis"] = _memory(cfg, model, shape, mesh, policy)
    if collect_hlo:
        rec["hlo_analysis"] = cost.as_dict()
        rec["collectives"] = _collectives(cost)
    mf = model_flops(cfg, shape)
    rec["model_flops_global"] = mf
    if collect_hlo:
        n_dev = math.prod(sizes.values())
        rec["roofline"] = roofline_terms({
            "dot_flops": cost.dot_flops,
            "traffic_bytes": cost.traffic_bytes,
            "collective_bytes": cost.total_collective_bytes,
        })
        rec["roofline"]["model_flops_per_device"] = mf / n_dev
        useful = (mf / n_dev) / cost.dot_flops if cost.dot_flops else None
        rec["roofline"]["useful_flops_ratio"] = useful
    rec["total_s"] = round(time.time() - t0, 2)
    return rec


def dryrun_pair(arch: str, shape_name: str, multi_pod: bool = False, collect_hlo: bool = True,
                lower_only: bool = False, microbatches: int = 1, fsdp_only: tuple = (),
                batch_both_axes: bool = False, embed_single_axis: bool = False,
                ssd_chunk: int = 0, shard_ssm_heads: bool = False, params_bf16: bool = False,
                shard_attn_heads: bool = False, variant: str = "",
                full_depth: bool = False) -> Dict[str, Any]:
    """Trace one (arch × shape) pair on the production mesh, in a fake world
    of its size. Policy knobs (the reference's): ``microbatches`` —
    gradient accumulation in the train step; ``fsdp_only`` — container
    names whose parameters skip ``model`` sharding; ``batch_both_axes`` —
    the batch over every mesh axis (pure data parallelism);
    ``embed_single_axis`` — vocab-only embedding sharding; ``ssd_chunk`` —
    the SSD chunk length; ``shard_ssm_heads`` / ``shard_attn_heads`` — the
    head pins; ``params_bf16`` — bf16 parameters."""
    shape = INPUT_SHAPES[shape_name]
    cfg = pair_config(arch, shape, ssd_chunk, shard_ssm_heads, params_bf16, shard_attn_heads)
    size = 512 if multi_pod else 256
    with fake_world(size):
        mesh = make_production_mesh(multi_pod=multi_pod)
        return record(cfg, shape, mesh, arch=arch, multi_pod=multi_pod, collect_hlo=collect_hlo,
                      lower_only=lower_only, microbatches=microbatches, fsdp_only=fsdp_only,
                      batch_both_axes=batch_both_axes, embed_single_axis=embed_single_axis,
                      variant=variant, full_depth=full_depth)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", type=str, default=DEFAULT_OUT)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--fsdp-only", nargs="*", default=[],
                    help="container names to shard data-only (e.g. blocks super rest)")
    ap.add_argument("--batch-both-axes", action="store_true")
    ap.add_argument("--embed-single-axis", action="store_true")
    ap.add_argument("--ssd-chunk", type=int, default=0)
    ap.add_argument("--shard-ssm-heads", action="store_true")
    ap.add_argument("--params-bf16", action="store_true")
    ap.add_argument("--shard-attn-heads", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="the reference's policy bundle per arch: head pins (attention and "
                         "SSM), vocab-only embedding sharding, input-dim FSDP for SSM blocks, "
                         "8 training microbatches, bf16 parameters")
    ap.add_argument("--variant", type=str, default="")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = list(all_configs()) if (args.all or args.arch is None) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    pairs = [(a, s, mp) for a in archs for s in shapes for mp in meshes]

    n_ok = 0
    for a, s, mp in pairs:
        tag = f"{a}__{s}__{'2x16x16' if mp else '16x16'}"
        if args.variant:
            tag += f"__{args.variant}"
        path = os.path.join(args.out, tag + ".json")
        if args.skip_existing and os.path.exists(path):
            print(f"[skip] {tag}")
            n_ok += 1
            continue
        print(f"[dryrun] {tag} ...", flush=True)
        kw = dict(microbatches=args.microbatches, fsdp_only=tuple(args.fsdp_only),
                  batch_both_axes=args.batch_both_axes, embed_single_axis=args.embed_single_axis,
                  ssd_chunk=args.ssd_chunk, shard_ssm_heads=args.shard_ssm_heads,
                  params_bf16=args.params_bf16, shard_attn_heads=args.shard_attn_heads)
        if args.optimized:
            kw.update(embed_single_axis=True, params_bf16=True, shard_attn_heads=True)
            if get_config(a).family in ("ssm", "hybrid"):
                kw.update(shard_ssm_heads=True, fsdp_only=("blocks", "super", "rest"))
            if INPUT_SHAPES[s].kind == "train":
                kw.update(microbatches=8)
        try:
            rec = dryrun_pair(a, s, multi_pod=mp, variant=args.variant, **kw)
            with open(path, "w") as f:
                json.dump(rec, f, indent=2)
            ha = rec["hlo_analysis"]
            print(f"  ok trace={rec['lower_s']}s dot_flops={ha['dot_flops']:.3e} "
                  f"traffic={ha['traffic_bytes']:.3e}B coll={ha['total_collective_bytes']:.3e}B "
                  f"bottleneck={rec['roofline']['bottleneck']}", flush=True)
            n_ok += 1
        except Exception as e:  # one pair's failure is recorded; the others still run
            with open(path + ".err", "w") as f:
                f.write(traceback.format_exc())
            print(f"  FAIL {type(e).__name__}: {e}", flush=True)
    print(f"{n_ok}/{len(pairs)} combinations traced; "
          f"torch.cuda.is_initialized()={torch.cuda.is_initialized()}")
    return 0 if n_ok == len(pairs) else 1


if __name__ == "__main__":
    raise SystemExit(main())
