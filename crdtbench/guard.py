"""The benchmark measures the PyTorch port alone: no module of the JAX
package, of JAX or of Flax may be loaded in its process. Names are compared
by their top-level part (before the first dot), whole: ``repro_torch`` is
not ``repro``."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset(("jax", "jaxlib", "flax", "repro"))


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in list(names) if m.split(".")[0] in FORBIDDEN)


def check(when: str, modules=None) -> None:
    """Raise ``SystemExit`` (code 3) naming what was found, if anything."""
    found = forbidden_modules(modules)
    if found:
        print(f"crdtbench: refusing to run: {when}, the process holds "
              f"{', '.join(found[:20])}", file=sys.stderr)
        raise SystemExit(3)
