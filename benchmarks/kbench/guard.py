"""The check that nothing of JAX reached the process."""

from __future__ import annotations

import sys

# compared as whole top-level names: ``seekr_tpu_torch`` begins with ``seekr_tpu``
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "seekr_tpu"})


def forbidden_modules(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    return sorted({name.split(".", 1)[0] for name in names} & FORBIDDEN)
