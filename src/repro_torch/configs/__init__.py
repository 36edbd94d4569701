"""Per-architecture configs and the paper's own config.

The port of ``repro.configs``.  Importing this package registers the
:class:`~repro_torch.configs.base.ArchSpec` of the seven decoders the
port runs: the five dense ones (tinyllama-1.1b, qwen2-7b, granite-3-2b,
gemma3-1b, phi-3-vision-4.2b), rwkv6-7b (RWKV6) and recurrentgemma-2b
(RG-LRU with local attention); use ``get_arch("<id>")`` /
``list_archs()``.  The reference also registers deepseek-v3-671b,
llama4-scout-17b and seamless-m4t-medium: their MLA, MoE and
encoder-decoder blocks wait for ROADMAP item M12c.
:mod:`.deepmapping_paper` holds the paper's workload configs.
"""

from repro_torch.configs.base import SHAPES, ArchSpec, get_arch, list_archs  # noqa: F401

# side-effect registration — one module per ported architecture
from repro_torch.configs import gemma3_1b  # noqa: F401
from repro_torch.configs import granite3_2b  # noqa: F401
from repro_torch.configs import phi3_vision_4_2b  # noqa: F401
from repro_torch.configs import qwen2_7b  # noqa: F401
from repro_torch.configs import recurrentgemma_2b  # noqa: F401
from repro_torch.configs import rwkv6_7b  # noqa: F401
from repro_torch.configs import tinyllama_1_1b  # noqa: F401
from repro_torch.configs import deepmapping_paper  # noqa: F401
