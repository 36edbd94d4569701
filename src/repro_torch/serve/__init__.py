"""Serving: the DeepMapping batched lookup server (the paper's
deployment), as ``repro.serve`` exports it.

The reference's ``repro.serve`` also exports ``make_prefill_step`` and
``make_decode_step`` from ``serve_step.py``.  Those serve the LM
substrate and come with it (ROADMAP item M12); this package has no
``serve_step`` yet.
"""

from repro_torch.serve.engine import LookupServer, ServeStats  # noqa: F401
