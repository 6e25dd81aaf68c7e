"""Persistent compilation cache for the compiled routes.

Counterpart of ``mnasnet_tpu/utils/compilation_cache.py``. The reference
points JAX's on-disk compile cache at a directory so that a restarted job
skips its XLA compiles. The port runs eagerly; what it compiles is the
``"compile"`` route of :class:`~mnasnet_tpu_torch.utils.routing.BatchRouted`
(``torch.compile`` with Inductor), whose costly parts are Inductor's code
generation and Triton's kernel builds. Both have on-disk caches, keyed on
the graph, the compiler versions and the options: Inductor's FX-graph cache
under ``TORCHINDUCTOR_CACHE_DIR`` and Triton's under ``TRITON_CACHE_DIR``.
This module points both at one directory. Dynamo still traces each new
shape in a new process; the cache saves what comes after the trace.

Resolution order: explicit ``--compilation-cache DIR`` flag -> the
``MNASNET_TPU_COMPILATION_CACHE`` environment variable -> disabled.
``none``/``off``/``0`` (any case) disable explicitly. It must run before the
first compile of the process to cover it.
"""

from __future__ import annotations

import os

_ENV_KEY = "MNASNET_TPU_COMPILATION_CACHE"
_DISABLED = ("", "none", "off", "0")
# The environment variables of the caches, and what they held before
# enable_compilation_cache set them.
_CACHE_VARS = ("TORCHINDUCTOR_CACHE_DIR", "TRITON_CACHE_DIR")
_saved: dict[str, str | None] = {}


def enable_compilation_cache(path: str | None = None) -> str | None:
    """Point Inductor's FX-graph cache and Triton's cache at ``path`` (or the
    environment variable's directory), created if missing. Returns the
    resolved directory, or None if disabled."""
    if path is None:
        path = os.environ.get(_ENV_KEY)
    if path is None or path.strip().lower() in _DISABLED:
        return None
    path = os.path.abspath(os.path.expanduser(path))
    os.makedirs(path, exist_ok=True)
    import torch._inductor.config as inductor_config

    for var in _CACHE_VARS:
        _saved.setdefault(var, os.environ.get(var))
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = path
    os.environ["TRITON_CACHE_DIR"] = os.path.join(path, "triton")
    inductor_config.fx_graph_cache = True
    return path


def disable_compilation_cache() -> None:
    """Give the cache variables back the values they had before
    :func:`enable_compilation_cache` (used by tests)."""
    for var, value in _saved.items():
        if value is None:
            os.environ.pop(var, None)
        else:
            os.environ[var] = value
    _saved.clear()
