"""``ops.kernel_counters()``, the registry of the CUDA kernel wrappers,
holds every function of an ``ops`` module that carries a ``launches``
counter: found by walking the modules, not by a second list."""

import importlib
import pkgutil

from astro_sph_tools_tpu_torch import ops
from astro_sph_tools_tpu_torch.ops import kernel_counters


def counted_functions() -> dict:
    """{(module, name): function} of every function defined in an ``ops``
    module with a ``launches`` attribute."""
    found = {}
    for info in pkgutil.iter_modules(ops.__path__):
        module = importlib.import_module(f"{ops.__name__}.{info.name}")
        for name, obj in vars(module).items():
            if callable(obj) and getattr(obj, "__module__", None) == module.__name__ and hasattr(obj, "launches"):
                found[(module.__name__, name)] = obj
    return found


def test_registry_holds_every_counted_wrapper():
    registered = list(kernel_counters().values())
    found = counted_functions()
    assert len(found) >= 10
    missing = [key for key, fn in found.items() if not any(fn is r for r in registered)]
    assert missing == []
    assert len({id(fn) for fn in registered}) == len(registered) == len(found)


def test_registry_names_the_oversize_route():
    counters = kernel_counters()
    from astro_sph_tools_tpu_torch.ops.deposit_wide import deposit_wide

    assert counters["deposit_wide"] is deposit_wide
    assert all(isinstance(fn.launches, int) for fn in counters.values())
