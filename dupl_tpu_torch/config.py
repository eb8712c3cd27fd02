"""The recipe dataclasses of ``dupl_tpu/config.py``, shared with the port.

That module is plain dataclasses, but importing it as ``dupl_tpu.config``
runs ``dupl_tpu/__init__.py``, which imports the whole JAX package.  So the
file is loaded by path under a name of its own: one source of truth for every
recipe constant, and no JAX in the port's process.  The classes are distinct
objects from ``dupl_tpu.config``'s; both sides only read attributes, so a
config built with either module drives either package.
"""

from __future__ import annotations

import importlib.util
import os
import sys

_NAME = "dupl_tpu_torch._reference_config"


def _load():
    pkg = importlib.util.find_spec("dupl_tpu")  # locates, does not import
    if pkg is None or not pkg.submodule_search_locations:
        raise ImportError("dupl_tpu_torch.config needs the dupl_tpu package "
                          "source (dupl_tpu/config.py) on the path")
    path = os.path.join(list(pkg.submodule_search_locations)[0], "config.py")
    spec = importlib.util.spec_from_file_location(_NAME, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[_NAME] = mod  # dataclasses resolve their module while built
    spec.loader.exec_module(mod)
    return mod


_cfg = _load()

VOC_CLASS_LIST = _cfg.VOC_CLASS_LIST
COCO_CLASS_LIST = _cfg.COCO_CLASS_LIST
ModelConfig = _cfg.ModelConfig
CrfConfig = _cfg.CrfConfig
ParConfig = _cfg.ParConfig
DataConfig = _cfg.DataConfig
TrainConfig = _cfg.TrainConfig
voc_config = _cfg.voc_config
coco_config = _cfg.coco_config

__all__ = ["VOC_CLASS_LIST", "COCO_CLASS_LIST", "ModelConfig", "CrfConfig",
           "ParConfig", "DataConfig", "TrainConfig", "voc_config", "coco_config"]
