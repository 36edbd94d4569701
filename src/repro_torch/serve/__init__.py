"""Serving substrate: prefill/decode steps for the LM architectures and
the DeepMapping batched lookup server (the paper's deployment), as
``repro.serve`` exports them."""

from repro_torch.serve.serve_step import make_decode_step, make_prefill_step  # noqa: F401
from repro_torch.serve.engine import LookupServer, ServeStats  # noqa: F401
