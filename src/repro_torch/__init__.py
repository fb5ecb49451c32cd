"""StorInfer on PyTorch + CUDA: the port of the JAX package ``repro``.

Public API — the same front door as the reference:

    from repro_torch import StorInfer, SystemCfg

Everything below is re-exported lazily from ``repro_torch.api``, so
importing a leaf module never pays for the rest. The port imports nothing
of ``repro`` and nothing of JAX.
"""
from __future__ import annotations

_API_EXPORTS = (
    "StorInfer", "SystemCfg", "EngineCfg", "SystemStats",
    "QueryResult", "RuntimeStats",
    "EmbedderProtocol", "IndexProtocol", "IndexCaps", "index_caps",
    "register_embedder", "register_index",
    "make_embedder", "make_index", "make_pipeline", "tier_of",
)

__all__ = list(_API_EXPORTS)


def __getattr__(name):
    if name in _API_EXPORTS:
        from repro_torch import api
        return getattr(api, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_API_EXPORTS))
