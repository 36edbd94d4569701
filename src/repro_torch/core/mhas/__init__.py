"""Multi-task Hybrid Architecture Search (paper §IV-C, Algorithm 2) — the
port of ``repro.core.mhas``.

ENAS-style parameter sharing: every candidate architecture is a masked
sub-network of one max-width weight bank (:class:`SearchSpace`), so
child models never train from scratch and every child runs at one shape.
The LSTM controller (:mod:`repro_torch.core.mhas.controller`) samples
(shared depth, shared sizes, per-task private depth/sizes)
autoregressively and is trained with REINFORCE (:func:`run_mhas`)
against the paper's Eq. 1 — the *whole hybrid structure's* compression
ratio, including the auxiliary table the sampled model would need.  The
chosen child is cut from the bank as a standalone
``repro_torch.core.model`` params tree, fine-tuned, and handed to
``DeepMappingStore.build`` as ``spec``/``params``.
"""

from repro_torch.core.mhas import controller  # noqa: F401
from repro_torch.core.mhas.search import MHASConfig, MHASResult, run_mhas  # noqa: F401
from repro_torch.core.mhas.search_space import SearchSpace  # noqa: F401
