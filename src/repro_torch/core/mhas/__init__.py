"""Multi-task Hybrid Architecture Search (paper §IV-C, Algorithm 2) — the
port's search space and controller.

ENAS-style parameter sharing: every candidate architecture is a masked
sub-network of one max-width weight bank (:class:`SearchSpace`), so
child models never train from scratch and every child runs at one shape.
The LSTM controller (:mod:`repro_torch.core.mhas.controller`) samples
(shared depth, shared sizes, per-task private depth/sizes)
autoregressively; a sampled child is cut from the bank as a standalone
``repro_torch.core.model`` params tree, which the fused kernels serve.

The search itself — ``MHASConfig``, ``MHASResult`` and ``run_mhas``,
REINFORCE against the paper's Eq. 1 — is not ported yet (ROADMAP item
M10b).
"""

from repro_torch.core.mhas import controller  # noqa: F401
from repro_torch.core.mhas.search_space import SearchSpace  # noqa: F401
