"""Custom statistical-model plugins (port of kmdiff_tpu/plugins.py).

The reference dlopens a shared object exposing `plugin_name` +
`create8/16/32` factories returning IModel implementations
(reference: include/kmdiff/model_manager.hpp:19-105, plugins/ex_model.cpp).
Here a plugin is a Python module, loaded by file path or by module:attr
spec, exposing a `create_model(config: str) -> IModel` factory. Models
implement kmdiff_tpu_torch.core.model.IModel at one of three altitudes
(the pipeline takes the first one a model has, fastest first):

  * `process_block_torch(counts, nb_controls)` — torch function fed int32
    count tiles of at most BLOCK_ROWS rows ON THE PROCESSOR'S DEVICE
    (example: kmdiff_tpu_torch/examples/plugins/device_fold_change_model.py),
  * `process_block(counts, nb_controls)` — vectorized numpy
    (example: kmdiff_tpu_torch/examples/plugins/fold_change_model.py),
  * scalar `process(controls, cases)` — reference-parity per-k-mer ABI;
    falls back to a per-row loop (warned above 1e6 rows).

The JAX package's `process_block_jax` is not an ABI of the port: a model
with no other is refused when it is loaded.
"""

from __future__ import annotations

import importlib
import importlib.util
import os

from kmdiff_tpu_torch.core.model import IModel
from kmdiff_tpu_torch.utils.exceptions import KmdiffError
from kmdiff_tpu_torch.utils.logging import logger


class PluginError(KmdiffError):
    pass


def block_abi(model) -> str:
    """The ABI the pipeline scores `model` through: "torch", "numpy" or
    "scalar"; raises PluginError for a model with none of them."""
    if hasattr(model, "process_block_torch"):
        return "torch"
    cls = type(model)
    if getattr(cls, "process_block", IModel.process_block) is not IModel.process_block:
        return "numpy"
    if getattr(cls, "process", IModel.process) is not IModel.process:
        return "scalar"
    jax_only = (" (process_block_jax is the JAX package's device ABI)"
                if hasattr(model, "process_block_jax") else "")
    raise PluginError(
        f"plugin model {cls.__name__} implements no ABI of kmdiff_tpu_torch"
        f"{jax_only}: implement process_block_torch (device), process_block "
        "(numpy) or process (scalar)"
    )


def load_model_plugin(spec: str, config: str = "") -> IModel:
    """Load a model plugin.

    spec: either a path to a .py file, or "module.path" /
    "module.path:factory_name" (factory defaults to `create_model`).
    """
    factory_name = "create_model"
    if os.path.exists(spec) and spec.endswith(".py"):
        name = os.path.splitext(os.path.basename(spec))[0]
        mod_spec = importlib.util.spec_from_file_location(f"kmdiff_plugin_{name}", spec)
        module = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(module)
    else:
        modname, _, attr = spec.partition(":")
        if attr:
            factory_name = attr
        try:
            module = importlib.import_module(modname)
        except ImportError as e:
            raise PluginError(f"cannot import model plugin {spec!r}: {e}") from e

    factory = getattr(module, factory_name, None)
    if factory is None:
        raise PluginError(
            f"plugin {spec!r} does not expose a {factory_name}() factory"
        )
    model = factory(config)
    block_abi(model)
    name = getattr(module, "PLUGIN_NAME", getattr(module, "__name__", spec))
    logger.info("Plugin loaded: %s", name)
    return model
