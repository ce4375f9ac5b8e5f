"""Architecture registry of the port: ``get_config(name)`` / ``--arch <id>``.

The port's copy of ``repro.configs``, with every architecture of the JAX
package's registry: the dense family (``tinyllama-1.1b``,
``stablelm-12b``, ``codeqwen1.5-7b``, ``deepseek-coder-33b``), the RG-LRU
hybrid ``recurrentgemma-9b``, the M-RoPE language model of
``qwen2-vl-7b``, the MoE family (``phi3.5-moe-42b-a6.6b``, and
``deepseek-v2-236b`` with MLA), the Mamba2 SSD model ``mamba2-130m`` and
the encoder-decoder ``whisper-large-v3``.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

__all__ = ["ALIASES", "ARCH_IDS", "get_config", "get_reduced"]

#: the architectures this package can build
ARCH_IDS: List[str] = ["tinyllama_1_1b", "stablelm_12b", "codeqwen15_7b",
                       "deepseek_coder_33b", "recurrentgemma_9b",
                       "qwen2_vl_7b", "phi35_moe_42b", "deepseek_v2_236b",
                       "mamba2_130m", "whisper_large_v3"]

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


def _module(name: str):
    mod_name = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if mod_name not in ARCH_IDS:
        raise KeyError(f"unknown architecture {name!r}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(name: str) -> ModelConfig:
    """The published configuration of ``name``."""
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    """A small same-family configuration of ``name`` for CPU tests."""
    return _module(name).reduced()
