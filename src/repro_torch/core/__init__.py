"""The DeepMapping hybrid learned structure in PyTorch — multi-task
memorization MLP + auxiliary accuracy-assurance table + existence
bitvector + decode maps — and the modification workflows."""

from repro_torch.core.aux_table import AuxTable  # noqa: F401
from repro_torch.core.bitvector import BitVector  # noqa: F401
from repro_torch.core.encoding import KeyEncoder, ValueCodec, build_codecs  # noqa: F401
from repro_torch.core.hybrid import DeepMappingConfig, DeepMappingStore  # noqa: F401
from repro_torch.core.inference import EngineCache, EngineStats, InferenceEngine  # noqa: F401
from repro_torch.core.model import (  # noqa: F401
    MappingMLP,
    MLPSpec,
    forward_digits,
    forward_onehot,
    init_params,
)
from repro_torch.core.table import Table, pack_composite_key  # noqa: F401
from repro_torch.core.trainer import TrainConfig  # noqa: F401
