"""The port's API boundary: every public name of ``accelerate_tpu`` (its
``__all__`` and the names its ``__getattr__`` serves lazily) resolves from
``accelerate_tpu_torch`` or is listed in ``utils/api_boundary.py`` with
the ROADMAP.md Queue A item that ports it, never both; and so does every
public name of the subpackages ``utils``, ``parallel``, ``models``,
``ops``, ``telemetry`` and ``resilience`` from the port's subpackage of the
same name (``__all__`` where the JAX subpackage has one, else its public
non-module attributes), where a listed name may also say that it has no
counterpart."""

import importlib
import importlib.util
import re
import types

import pytest

import accelerate_tpu
import accelerate_tpu_torch
from accelerate_tpu_torch.utils.api_boundary import LATER_ITEMS, SUBPACKAGE_LATER_ITEMS

SUBPACKAGES = ("utils", "parallel", "models", "ops", "telemetry", "resilience")
ITEM = re.compile(r"(7|8|10|11[ab]?|12[abcd]?|13): .+|no counterpart: .+")


def _jax_public_names() -> set:
    return (set(accelerate_tpu.__all__) | accelerate_tpu._LAZY_EXTRAS
            | accelerate_tpu._BIG_MODELING | accelerate_tpu._MODELING_UTILS
            | accelerate_tpu._QUANTIZATION)


def test_every_public_name_resolves_or_names_its_item():
    names = _jax_public_names()
    resolved = {n for n in names if hasattr(accelerate_tpu_torch, n)}
    assert resolved | set(LATER_ITEMS) == names, sorted(names - resolved - set(LATER_ITEMS))
    assert not resolved & set(LATER_ITEMS), sorted(resolved & set(LATER_ITEMS))


def test_later_items_name_a_queue_a_item():
    for name, item in LATER_ITEMS.items():
        assert ITEM.fullmatch(item) and not item.startswith("no counterpart"), (name, item)
    assert set(SUBPACKAGE_LATER_ITEMS) == set(SUBPACKAGES)
    for sub, items in SUBPACKAGE_LATER_ITEMS.items():
        for name, item in items.items():
            assert ITEM.fullmatch(item), (sub, name, item)


def test_port_exports_resolve():
    for name in accelerate_tpu_torch.__all__:
        assert getattr(accelerate_tpu_torch, name) is not None, name


def _subpackage_names(module) -> dict:
    """``{name: object}`` of a JAX subpackage's public names."""
    if hasattr(module, "__all__"):
        return {n: getattr(module, n) for n in module.__all__}
    return {n: getattr(module, n) for n in dir(module)
            if not n.startswith("_") and not isinstance(getattr(module, n), types.ModuleType)}


def _resolves(port, name: str, reference) -> bool:
    """A JAX module name resolves to a port module of that name; any other
    name to a port attribute that is not a module (``ops.flash_attention``
    is the function, as in the JAX package)."""
    if isinstance(reference, types.ModuleType):
        return importlib.util.find_spec(f"{port.__name__}.{name}") is not None
    return hasattr(port, name) and not isinstance(getattr(port, name), types.ModuleType)


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_subpackage_name_resolves_or_names_its_item(sub):
    jax_names = _subpackage_names(importlib.import_module(f"accelerate_tpu.{sub}"))
    port = importlib.import_module(f"accelerate_tpu_torch.{sub}")
    later = SUBPACKAGE_LATER_ITEMS[sub]
    resolved = {n for n, obj in jax_names.items() if _resolves(port, n, obj)}
    assert resolved | set(later) == set(jax_names), sorted(set(jax_names) - resolved - set(later))
    assert not resolved & set(later), sorted(resolved & set(later))
    for name in resolved:  # constants keep the JAX package's values
        if isinstance(jax_names[name], (str, int, float, tuple)):
            assert getattr(port, name) == jax_names[name], name
    if hasattr(port, "__all__"):
        for name in port.__all__:
            assert getattr(port, name) is not None, (sub, name)
