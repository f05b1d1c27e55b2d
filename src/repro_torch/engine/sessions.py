"""The shared session cache: each stacked program is built once per semantic
identity and served from here on every later call.

Counterpart of ``repro.engine.sessions``. The reference caches jitted
programs; PyTorch runs eagerly, so what is cached here is the *built*
stacked step: the functional loss over a parameter template, its ``vmap``ped
gradient and the stacked optimizer update (the SSL session's), the stacked
fit step (the server's), and the small closures of the k-means search, the
Eq. 10 estimate and the few-shot gate. A later CUDA-graph capture hangs on
the same keys.

Keys never carry batch width or data shapes: the parameters, data, draws
and masks all travel as arguments, so one built step serves every seed and
every scenario of a fold. The counterpart of the reference's ``model_key``
is an :class:`~repro_torch.checkpoint.artifact.ExtractorSpec`: equal specs
build the same module. :func:`module_spec` reads the spec back off a built
module, so a task that carries only its modules still has a key.

Hits and misses are counted per domain, the first element of every key:
``"ssl"``, ``"server_fit"``, ``"kmeans"``, ``"sdpa"``, ``"fewshot_gate"``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from torch import nn

from repro_torch.checkpoint.artifact import ExtractorSpec
from repro_torch.models.extractors import CNNExtractor, Dense

_SESSION_CACHE: Dict[tuple, Any] = {}
_CACHE_STATS: Dict[str, Dict[str, int]] = {}


def _domain_stats(domain: str) -> Dict[str, int]:
    return _CACHE_STATS.setdefault(domain, {"hits": 0, "misses": 0})


def session_cache_stats(domain: Optional[str] = None) -> Dict[str, int]:
    """``{"hits": .., "misses": ..}`` over every domain, or of ``domain``."""
    if domain is not None:
        return dict(_domain_stats(domain))
    out = {"hits": 0, "misses": 0}
    for st in _CACHE_STATS.values():
        out["hits"] += st["hits"]
        out["misses"] += st["misses"]
    return out


def session_cache_stats_by_domain() -> Dict[str, Dict[str, int]]:
    """Per-domain hit and miss counters."""
    return {d: dict(st) for d, st in sorted(_CACHE_STATS.items())}


def clear_session_cache() -> None:
    _SESSION_CACHE.clear()
    _CACHE_STATS.clear()


def module_spec(m: nn.Module) -> Optional[ExtractorSpec]:
    """The spec that builds a module like ``m`` (any input width), or None
    for a module no spec describes (a model-zoo backbone): such a module
    never stacks with another."""
    if isinstance(m, Dense):
        dims = [m.layers[0].in_features] + [layer.out_features for layer in m.layers]
        return ExtractorSpec("mlp", dims[-1], hidden=tuple(dims[1:-1]))
    if isinstance(m, CNNExtractor):
        bps = m.blocks_per_stage
        widths = tuple(m.blocks[i].conv2.out_channels for i in range(0, len(m.blocks), bps))
        return ExtractorSpec("cnn", m.head.out_features, widths=widths, blocks_per_stage=bps)
    return None


def cached_session(domain: str, key: tuple, builder: Callable[[], Any]) -> Any:
    """The object cached under ``(domain,) + key``, built (one miss for
    ``domain``) on first use."""
    full = (domain,) + key
    stats = _domain_stats(domain)
    fn = _SESSION_CACHE.get(full)
    if fn is None:
        stats["misses"] += 1
        fn = builder()
        _SESSION_CACHE[full] = fn
    else:
        stats["hits"] += 1
    return fn
