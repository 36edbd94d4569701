#!/usr/bin/env python3
"""How far bf16 moves a recurrent LM's argmaxes, in the reference and in the port, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/lm_bf16_sensitivity.py \\
        [--arch rwkv6-7b] [--d-model 512] [--tokens 256] [--seed 0]

Cuts the arch's full config to ``--d-model`` (its depth, block plan and
vocabulary kept; heads of 64 for RWKV6, of 256 for RG-LRU's attention,
``d_ff`` 3.5 x and ``rglru_dim`` = ``--d-model``), draws its fp32
weights with the reference's ``init`` and one prompt of ``--tokens``
tokens from ``--seed``, and prefills it five ways: the reference (JAX)
in fp32 and in bf16 (every leaf cast but RG-LRU's fp32 ``a_param``, the
dtypes its bf16 init gives), and the port on the same weights in fp32,
in bf16, and in fp32 on the bf16-rounded weights.  For each pair it
prints the share of rows whose argmaxes are equal, over the rows whose
fp32 top-two margin is at least 0.1 (``chip_smoke.LM_MARGIN``), and at
margins of 0.25, 0.5 and 1.0.  ``chip_smoke.py``'s ``lm_recurrent``
phase sets its bf16 agreement bound from these shares.

It imports both packages, as the CPU tests do, and runs on the CPU only
(at d_model 512, rwkv6-7b holds 185 M parameters: about a minute).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
MARGINS = (0.1, 0.25, 0.5, 1.0)


def cut(cfg, d: int):
    """``cfg`` at width ``d``, depth and block plan kept."""
    if "rglru" in cfg.block_pattern:
        return dataclasses.replace(cfg, d_model=d, d_ff=int(3.5 * d), rglru_dim=d,
                                   num_heads=max(1, d // 256), num_kv_heads=1, head_dim=256)
    return dataclasses.replace(cfg, d_model=d, d_ff=int(3.5 * d), num_heads=d // 64,
                               num_kv_heads=d // 64, head_dim=64)


def agreement(got, want) -> dict:
    """{margin: (equal share, rows)} of ``got``'s argmaxes against
    ``want``'s over the rows where ``want``'s top-two margin clears it."""
    import numpy as np

    top2 = np.sort(want, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    equal = got.argmax(-1) == want.argmax(-1)
    return {m: (float(equal[margin >= m].mean()), int((margin >= m).sum())) for m in MARGINS}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="rwkv6-7b")
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--tokens", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro import configs as jconfigs
    from repro.models import DecoderLM as JDecoderLM
    from repro_torch.core.convert import params_from_numpy
    from repro_torch.core.model import _map_tree
    from repro_torch.models import DecoderLM, ModelConfig

    jcfg16 = cut(jconfigs.get_arch(args.arch).config, args.d_model)
    jcfg32 = dataclasses.replace(jcfg16, dtype="float32")
    jp32 = JDecoderLM(jcfg32).init(args.seed)
    jdtypes = jax.tree.map(lambda a: a.dtype, jax.eval_shape(JDecoderLM(jcfg16).init, args.seed))
    jp16 = jax.tree.map(lambda a, dt: a.astype(dt), jp32, jdtypes)
    toks = np.random.default_rng(args.seed).integers(0, jcfg32.vocab_size, (1, args.tokens))

    def jrun(cfg, p):
        fn = jax.jit(lambda p, t: JDecoderLM(cfg).apply(p, t, remat=False).astype(jnp.float32))
        return np.asarray(fn(p, jnp.asarray(toks)))

    ref32, ref16 = jrun(jcfg32, jp32), jrun(jcfg16, jp16)
    cfg32, cfg16 = (ModelConfig(**dataclasses.asdict(c)) for c in (jcfg32, jcfg16))
    tp32 = params_from_numpy(jax.device_get(jp32), device="cpu")
    tp16 = params_from_numpy(jax.device_get(jp16), device="cpu")
    tp32b = _map_tree(tp16, lambda t: t.float())

    def trun(cfg, p):
        with torch.no_grad():
            return DecoderLM(cfg).apply(p, torch.from_numpy(toks), remat=False).float().numpy()

    port32, port16, port32b = trun(cfg32, tp32), trun(cfg16, tp16), trun(cfg32, tp32b)
    out = {
        "arch": args.arch, "d_model": args.d_model, "num_layers": jcfg32.num_layers,
        "tokens": args.tokens, "seed": args.seed, "margins": list(MARGINS),
        "reference_bf16_vs_fp32": agreement(ref16, ref32),
        "port_bf16_vs_fp32": agreement(port16, port32),
        "port_fp32_on_bf16_weights_vs_fp32": agreement(port32b, port32),
        "port_bf16_vs_reference_bf16": agreement(port16, ref16),
        "port_fp32_vs_reference_fp32_max_abs": float(np.abs(port32 - ref32).max()),
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
