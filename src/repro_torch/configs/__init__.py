"""Architecture registry of the port: ``get_config(name)`` / ``--arch <id>``.

The port's copy of ``repro.configs``. Only the dense family is ported:
``tinyllama-1.1b``, ``stablelm-12b``, ``codeqwen1.5-7b`` and
``deepseek-coder-33b`` resolve; every other architecture of the JAX
package's registry raises ``NotImplementedError`` naming the ``ROADMAP.md``
item that ports it, and is never mapped to another model.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

__all__ = ["ALIASES", "ARCH_IDS", "get_config", "get_reduced"]

#: the architectures this package can build
ARCH_IDS: List[str] = ["tinyllama_1_1b", "stablelm_12b", "codeqwen15_7b",
                       "deepseek_coder_33b"]

#: assignment-sheet name → module id (the JAX package's table)
ALIASES: Dict[str, str] = {
    "recurrentgemma-9b": "recurrentgemma_9b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "stablelm-12b": "stablelm_12b",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "mamba2-130m": "mamba2_130m",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "whisper-large-v3": "whisper_large_v3",
}

#: architectures of the JAX package not ported yet, with what they wait for
#: and the items of ROADMAP.md §1 that port it
_NOT_PORTED: Dict[str, str] = {
    "recurrentgemma_9b": "RG-LRU blocks and windowed attention (items 2, 1)",
    "phi35_moe_42b": "the MoE family (item 2)",
    "deepseek_v2_236b": "MLA attention and the MoE family (item 2)",
    "mamba2_130m": "the Mamba2 SSD family (item 2)",
    "qwen2_vl_7b": "M-RoPE and the vision frontend (item 2)",
    "whisper_large_v3": "the encoder and cross-attention (items 2, 1)",
}


def _module(name: str):
    mod_name = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if mod_name in _NOT_PORTED:
        raise NotImplementedError(
            f"{name!r} is not ported to repro_torch yet: it needs "
            f"{_NOT_PORTED[mod_name]} of ROADMAP.md §1")
    if mod_name not in ARCH_IDS:
        raise KeyError(f"unknown architecture {name!r}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(name: str) -> ModelConfig:
    """The published configuration of ``name``."""
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    """A small same-family configuration of ``name`` for CPU tests."""
    return _module(name).reduced()
