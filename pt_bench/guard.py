"""The import guard: no module of JAX, of the JAX package or of the
reference's benchmark code is loaded.  Names are compared by their
top-level part (the text before the first dot) as a whole, since the port's
package name begins with the JAX package's."""

from __future__ import annotations

import sys
import types

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "unity_webgpu_pathtracer_tpu", "bench",
                       "experiments"})
# The port's own experiments (probes and timing helpers) are not the system
# under test either.
FORBIDDEN_PREFIXES = ("unity_webgpu_pathtracer_torch.experiments",)
PORT = "unity_webgpu_pathtracer_torch"
# The yardstick's own packages: they take nothing of the port either.
REFERENCE = ("pt_bench.reference", "pt_bench.check", "pt_bench.yardstick")


def forbidden(modules=None, extra=()) -> list:
    """Sorted names of loaded modules that the benchmark may not load;
    ``extra`` adds top-level names (the reference adds the port's)."""
    names = set(sys.modules if modules is None else modules)
    banned = FORBIDDEN | frozenset(extra)
    return sorted(n for n in names
                  if n.split(".", 1)[0] in banned
                  or any(n == p or n.startswith(p + ".") for p in FORBIDDEN_PREFIXES))


def reference_imports(modules=None) -> list:
    """Sorted names of forbidden modules, the port's among them, that a
    loaded module of the reference or the yardstick has bound: imported as
    a module, or a function, class or object taken from one.  A run loads
    the port beside the reference, so its ``sys.modules`` alone cannot show
    this."""
    mods = sys.modules if modules is None else modules
    origins = set()
    for name, mod in list(mods.items()):
        if mod is None or not any(name == p or name.startswith(p + ".") for p in REFERENCE):
            continue
        for value in list(vars(mod).values()):
            if isinstance(value, types.ModuleType):
                origins.add(value.__name__)
            else:
                origin = getattr(value, "__module__", None)
                if isinstance(origin, str):
                    origins.add(origin)
    return forbidden(origins, extra=(PORT,))
