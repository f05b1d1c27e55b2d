"""The engine's local-SSL step under the reference's names
(``repro.engine``'s ``PartyParams``, ``make_ssl_optimizer`` and
``make_ssl_step_fn``)."""

from repro_torch.engine.local_ssl import PartyParams, make_ssl_optimizer, make_ssl_step_fn

__all__ = ["PartyParams", "make_ssl_optimizer", "make_ssl_step_fn"]
