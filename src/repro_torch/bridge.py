"""Reference parameter pytrees ↔ the port's modules.

The one place weights cross between the packages. A reference pytree is a
nested dict of numpy arrays (or tensors) keyed exactly as
``repro.models.extractors`` keys it:

* MLP extractor and classifier: ``w{i}`` ``(in, out)``, ``b{i}`` ``(out,)``;
* CNN: ``stem`` and ``s{s}b{b}/{conv1, conv2, proj}`` as HWIO kernels,
  ``s{s}b{b}/gn{1,2}_{scale,bias}``, ``out_gn_{scale,bias}``,
  ``head_w`` ``(C, rep)``, ``head_b``.

The port stores ``nn.Linear`` weights as ``(out, in)`` and conv kernels as
OIHW, so dense weights are transposed and conv kernels permuted
``(3, 2, 0, 1)`` on the way in (and back on the way out).

Model-zoo pytrees (``repro.models.model_zoo``) are keyed ``embed/tok`` (and
``embed/unembed`` when untied), ``final_ln_scale``, ``rep_head`` for the zoo
extractor, and the family's blocks:

* dense and moe: ``blocks/{ln1_scale, ln2_scale, attn/{w_q, w_k, w_v, w_o[,
  b_q, b_k, b_v]}}`` with ``ffn/{w_gate, w_up, w_down}`` or ``moe/{router,
  w_gate_e, w_up_e, w_down_e[, shared/*]}``, a leading L axis on each;
* ssm: ``blocks/{ln_scale, mamba/{in_proj, conv_w, conv_bias, A_log, D,
  dt_bias, gate_norm_scale, out_proj}}`` with a leading L axis;
* hybrid: ``super/{ln_scale, mamba/*}`` with two leading axes (n_super,
  every), ``rest/*`` with one, and ``shared_attn/*`` (a dense block) with
  none.

The port keeps the reference's ``(in, out)`` layout there, so those leaves
copy as they are; each stacked axis becomes an index into a
``nn.ModuleList``, which stands in the parameter's name.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.extractors import CNNExtractor, Dense
from repro_torch.models.model_zoo import make_backbone
from repro_torch.models.zoo_extractor import ZooExtractor

Tree = Dict[str, Any]


def _tensor(x: Any) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.from_numpy(np.array(x))


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()


def _set(param: torch.Tensor, value: Any, name: str) -> None:
    value = _tensor(value)
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"{name}: shape {tuple(value.shape)} does not fit {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(value.to(param.dtype))


def _hwio_to_oihw(w: Any) -> torch.Tensor:
    return _tensor(w).permute(3, 2, 0, 1)


def _blocks(module: CNNExtractor):
    n = module.blocks_per_stage
    for i, block in enumerate(module.blocks):
        yield f"s{i // n}b{i % n}", block


def load_jax_params(module: nn.Module, params: Tree) -> nn.Module:
    """Copy a reference parameter pytree into ``module`` (in place).

    Raises ``ValueError`` on a missing key or a shape that does not fit."""
    try:
        if isinstance(module, Dense):
            expected = {f"{p}{i}" for i in range(len(module.layers)) for p in "wb"}
            if set(params) != expected:
                raise ValueError(f"keys {sorted(params)} are not {sorted(expected)}")
            for i, layer in enumerate(module.layers):
                _set(layer.weight, _tensor(params[f"w{i}"]).T, f"w{i}")
                _set(layer.bias, params[f"b{i}"], f"b{i}")
            return module
        if isinstance(module, CNNExtractor):
            _set(module.stem.weight, _hwio_to_oihw(params["stem"]), "stem")
            for pfx, block in _blocks(module):
                p = params[pfx]
                _set(block.conv1.weight, _hwio_to_oihw(p["conv1"]), f"{pfx}/conv1")
                _set(block.conv2.weight, _hwio_to_oihw(p["conv2"]), f"{pfx}/conv2")
                if (block.proj is None) != ("proj" not in p):
                    raise ValueError(f"{pfx}: projection shortcut mismatch")
                if block.proj is not None:
                    _set(block.proj.weight, _hwio_to_oihw(p["proj"]), f"{pfx}/proj")
                for g, gn in (("gn1", block.gn1), ("gn2", block.gn2)):
                    _set(gn.weight, p[f"{g}_scale"], f"{pfx}/{g}_scale")
                    _set(gn.bias, p[f"{g}_bias"], f"{pfx}/{g}_bias")
            _set(module.out_gn.weight, params["out_gn_scale"], "out_gn_scale")
            _set(module.out_gn.bias, params["out_gn_bias"], "out_gn_bias")
            _set(module.head.weight, _tensor(params["head_w"]).T, "head_w")
            _set(module.head.bias, params["head_b"], "head_b")
            return module
    except KeyError as e:
        raise ValueError(f"reference params lack key {e}") from None
    raise TypeError(f"no reference layout for {type(module).__name__}")


def to_jax_params(module: nn.Module) -> Tree:
    """The module's parameters as a reference-keyed pytree of float32 numpy
    arrays (the inverse of :func:`load_jax_params`). Its keys and shapes are
    also the template a checkpoint is read into."""
    if isinstance(module, Dense):
        tree: Tree = {}
        for i, layer in enumerate(module.layers):
            tree[f"w{i}"] = _numpy(layer.weight.T)
            tree[f"b{i}"] = _numpy(layer.bias)
        return tree
    if isinstance(module, CNNExtractor):

        def hwio(conv: nn.Conv2d) -> np.ndarray:
            return _numpy(conv.weight.permute(2, 3, 1, 0))

        tree = {"stem": hwio(module.stem)}
        for pfx, block in _blocks(module):
            p = {
                "conv1": hwio(block.conv1),
                "conv2": hwio(block.conv2),
                "gn1_scale": _numpy(block.gn1.weight),
                "gn1_bias": _numpy(block.gn1.bias),
                "gn2_scale": _numpy(block.gn2.weight),
                "gn2_bias": _numpy(block.gn2.bias),
            }
            if block.proj is not None:
                p["proj"] = hwio(block.proj)
            tree[pfx] = p
        tree["out_gn_scale"] = _numpy(module.out_gn.weight)
        tree["out_gn_bias"] = _numpy(module.out_gn.bias)
        tree["head_w"] = _numpy(module.head.weight.T)
        tree["head_b"] = _numpy(module.head.bias)
        return tree
    raise TypeError(f"no reference layout for {type(module).__name__}")


def _zoo_leaves(
    module: nn.Module,
) -> Iterator[Tuple[Tuple[str, ...], Tuple[int, ...], nn.Parameter]]:
    """(reference path, stacked indices, parameter) for every parameter of a
    zoo backbone or :class:`ZooExtractor`: the name's list indices are the
    indices into the reference's stacked axes, the rest is the path."""
    for name, p in module.named_parameters():
        parts = name.split(".")
        if parts[0] == "backbone":
            parts = parts[1:]
        path = tuple(k for k in parts if not k.isdigit())
        yield path, tuple(int(k) for k in parts if k.isdigit()), p


def _flat(tree: Tree, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def zoo_params_from_reference(tree: Tree, cfg: ArchConfig, device: DeviceLike = None):
    """A reference model-zoo pytree as the port's module: a
    :class:`ZooExtractor` when the tree has ``rep_head``, else the family's
    backbone (``model_zoo.make_backbone``), on ``device`` (``cuda`` unless
    the caller says ``cpu``). Raises ``ValueError`` on a missing or extra
    key or a shape that does not fit."""
    leaves = _flat(tree)
    dev = resolve_device(device)
    if ("rep_head",) in leaves:
        module = ZooExtractor(cfg, int(np.shape(leaves[("rep_head",)])[-1]), dev)
    else:
        module = make_backbone(cfg, dev)
    expected = {path for path, _, _ in _zoo_leaves(module)}
    if set(leaves) != expected:
        missing = sorted("/".join(k) for k in expected - set(leaves))
        extra = sorted("/".join(k) for k in set(leaves) - expected)
        raise ValueError(f"zoo tree keys differ: missing {missing}, unexpected {extra}")
    for path, index, p in _zoo_leaves(module):
        _set(p, _tensor(leaves[path])[index], "/".join(path))
    return module


def zoo_params_to_reference(module: nn.Module) -> Tree:
    """The inverse of :func:`zoo_params_from_reference`: a reference-keyed
    pytree of float32 numpy arrays, stacked blocks on their leading axes."""
    stacked: Dict[Tuple[str, ...], Dict[Tuple[int, ...], np.ndarray]] = {}
    tree: Tree = {}

    def put(path: Tuple[str, ...], value: np.ndarray) -> None:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value

    for path, index, p in _zoo_leaves(module):
        if index:
            stacked.setdefault(path, {})[index] = _numpy(p)
        else:
            put(path, _numpy(p))
    for path, arrays in stacked.items():
        axes = tuple(max(ix[a] for ix in arrays) + 1 for a in range(len(next(iter(arrays)))))
        out = np.empty(axes + next(iter(arrays.values())).shape, np.float32)
        for ix, a in arrays.items():
            out[ix] = a
        put(path, out)
    return tree
