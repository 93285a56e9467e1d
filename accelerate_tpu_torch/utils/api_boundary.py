"""The port's API boundary against the JAX package: every public name of
``accelerate_tpu`` (its ``__all__`` and the names its ``__getattr__``
serves lazily) either resolves from ``accelerate_tpu_torch`` or is listed
here with the ROADMAP.md Queue A item that ports it.
``tests/test_torch_api_boundary.py`` holds the two sets to the JAX
package's names, with no overlap, so a name cannot go missing unnoticed.
``accelerate_tpu.utils.jax_compat`` (JAX version shims) has no counterpart.
"""

from __future__ import annotations

__all__ = ["LATER_ITEMS"]

_MEMORY = "12: the operations stack (utils/memory.py)"
_LAUNCH = "12: the operations stack (launchers.py)"
_CONSOLE = "12: the operations stack (utils/rich.py, utils/tqdm.py, utils/imports.py)"
_PIPELINE = "11: remaining parallelism (parallel/pipeline.py)"

#: public name of the JAX package the port does not resolve yet -> "<Queue A
#: item>: <what it belongs to>"
LATER_ITEMS: "dict[str, str]" = {
    "LocalSGD": "11: remaining parallelism (local_sgd.py)",
    "ProfileKwargs": "12: the operations stack (Accelerator.profile)",
    "clear_device_cache": _MEMORY,
    "find_executable_batch_size": _MEMORY,
    "release_memory": _MEMORY,
    "debug_launcher": _LAUNCH,
    "notebook_launcher": _LAUNCH,
    "get_console": _CONSOLE,
    "is_rich_available": _CONSOLE,
    "rich": _CONSOLE,
    "rich_print": _CONSOLE,
    "tqdm": _CONSOLE,
    "prepare_pipeline": _PIPELINE,
    "prepare_pippy": _PIPELINE,
}
