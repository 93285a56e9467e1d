"""The port's API boundary: every public name of ``accelerate_tpu`` (its
``__all__`` and the names its ``__getattr__`` serves lazily) resolves from
``accelerate_tpu_torch`` or is listed in ``utils/api_boundary.py`` with
the ROADMAP.md Queue A item that ports it, never both."""

import re

import accelerate_tpu
import accelerate_tpu_torch
from accelerate_tpu_torch.utils.api_boundary import LATER_ITEMS


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
        assert re.fullmatch(r"(7|8|10|11|12|13): .+", item), (name, item)


def test_port_exports_resolve():
    for name in accelerate_tpu_torch.__all__:
        assert getattr(accelerate_tpu_torch, name) is not None, name
