"""The port's LM serve steps (``repro_torch.serve.serve_step``) and the
carry of LM weights and caches (``repro_torch.core.convert``), held
against the reference on the CPU.

A decode sequence through ``make_cache_factory`` and ``make_decode_step``
follows the reference's ``DecoderLM.decode_step`` step for step (logits
within 1e-4, absolute and relative; cache contents and ``len`` alike) on
the five dense SMOKE configs and ``test_models.py``'s dense and windowed
configs, and reproduces the port's own ``make_prefill_step`` within the
reference's decode-against-forward tolerance (2e-3).  Weights come from
the reference's ``init`` through ``params_from_numpy``; bf16 leaves cross
bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import DecoderLM as JDecoderLM
from repro.serve import serve_step as jserve
from repro_torch import serve as tserve
from repro_torch.core.convert import BF16_BITS, params_from_numpy, params_to_numpy
from repro_torch.models import DecoderLM
from repro_torch.serve import serve_step
from test_torch_lm_models import MODEL_CASES, TOL, close, cpu, equiv_config, tcfg_of, tokens

#: Decode against the full forward: the reference's own tolerance
#: (``tests/test_models.py::TestDecodeEquivalence``).
DECODE_TOL = 2e-3


def _leaves_with_paths(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_paths(v, path + (i,))
    else:
        yield path, tree


class TestDecodeSequence:
    @pytest.mark.parametrize("name,jcfg", MODEL_CASES, ids=[n for n, _ in MODEL_CASES])
    def test_decode_follows_the_reference(self, name, jcfg):
        cfg = tcfg_of(jcfg)
        jp = JDecoderLM(jcfg).init(0)
        tp = cpu(jp)
        B, S, T = 2, 12, 15
        toks = tokens(jcfg, B, S, seed=1)
        jstep = jax.jit(jserve.make_decode_step(jcfg))
        jcache = jserve.make_cache_factory(jcfg)(B, T)
        step = serve_step.make_decode_step(cfg, device="cpu")
        cache = serve_step.make_cache_factory(cfg, device="cpu")(B, T)
        outs = []
        for t in range(S):
            want, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t:t + 1]))
            got, cache = step(tp, cache, toks[:, t:t + 1])
            assert got.shape == (B, 1, jcfg.vocab_size)
            close(got, want)
            outs.append(got[:, 0])
        assert int(cache["len"]) == int(jcache["len"]) == S
        assert cache["len"].dtype == torch.int32 and cache["len"].dim() == 0
        jleaves = dict(_leaves_with_paths(jax.device_get(jcache["layers"])))
        tleaves = dict(_leaves_with_paths(cache["layers"]))
        assert jleaves.keys() == tleaves.keys()
        for path, want in jleaves.items():
            if want is None:
                assert tleaves[path] is None
            else:
                assert tuple(tleaves[path].shape) == want.shape, path
                close(tleaves[path], want)
        # the port's decode against the port's own prefill
        full = serve_step.make_prefill_step(cfg, device="cpu")(tp, {"tokens": toks})
        np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                                   rtol=DECODE_TOL, atol=DECODE_TOL)

    def test_decode_past_the_cache_clamps_as_the_reference(self):
        """More steps than slots: the reference's dynamic_update_slice
        clamps the write to the last slot; the port's does the same."""
        jcfg = equiv_config("dense")
        cfg = tcfg_of(jcfg)
        jp = JDecoderLM(jcfg).init(0)
        tp = cpu(jp)
        toks = tokens(jcfg, 2, 6, seed=2)
        jstep = jax.jit(jserve.make_decode_step(jcfg))
        jcache = jserve.make_cache_factory(jcfg)(2, 4)
        step = serve_step.make_decode_step(cfg, device="cpu")
        cache = serve_step.make_cache_factory(cfg, device="cpu")(2, 4)
        for t in range(6):
            want, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t:t + 1]))
            got, cache = step(tp, cache, toks[:, t:t + 1])
            close(got, want)

    def test_reference_cache_carries_over(self):
        """A reference cache after a few steps, carried with
        params_from_numpy, decodes on in the port as in the reference."""
        jcfg = jconfigs.get_arch("gemma3-1b").smoke
        jp = JDecoderLM(jcfg).init(0)
        tp = cpu(jp)
        toks = tokens(jcfg, 2, 14, seed=3)
        jstep = jax.jit(jserve.make_decode_step(jcfg))
        jcache = jserve.make_cache_factory(jcfg)(2, 16)
        for t in range(10):
            _, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t:t + 1]))
        cache = cpu(jcache)
        assert cache["len"].dim() == 0 and int(cache["len"]) == 10
        step = serve_step.make_decode_step(tcfg_of(jcfg), device="cpu")
        for t in range(10, 14):
            want, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t:t + 1]))
            got, cache = step(tp, cache, toks[:, t:t + 1])
            close(got, want)

    def test_the_old_cache_is_left_as_it_was(self):
        """Decode is functional, as the reference's: the step returns new
        cache tensors and leaves the caller's cache unchanged."""
        cfg = tcfg_of(equiv_config("windowed"))
        tp = DecoderLM(cfg).init(seed=0, device="cpu")
        cache = serve_step.make_cache_factory(cfg, device="cpu")(2, 5)
        _, new = serve_step.make_decode_step(cfg, device="cpu")(tp, cache, [[1], [2]])
        zero = [t for _, t in _leaves_with_paths(cache["layers"]) if t is not None]
        assert all(bool((t == 0).all()) for t in zero) and int(cache["len"]) == 0
        assert int(new["len"]) == 1


class TestPrefillStep:
    @pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "granite-3-2b"])
    def test_prefill_matches_the_reference(self, arch):
        jcfg = jconfigs.get_arch(arch).smoke
        jp = JDecoderLM(jcfg).init(0)
        batch = {"tokens": tokens(jcfg, 2, 10, seed=4)}
        if jcfg.modality == "vision":
            batch["patch_embeds"] = np.random.default_rng(5).normal(
                size=(2, 3, jcfg.d_model)).astype(np.float32)
        want = jserve.make_prefill_step(jcfg)(jp, {k: jnp.asarray(v) for k, v in batch.items()})
        got = serve_step.make_prefill_step(tcfg_of(jcfg), device="cpu")(cpu(jp), batch)
        close(got, want)
        assert not got.requires_grad

    def test_the_package_exports_the_steps(self):
        assert tserve.make_prefill_step is serve_step.make_prefill_step
        assert tserve.make_decode_step is serve_step.make_decode_step
        assert tserve.LookupServer.__name__ == "LookupServer"

    def test_encoder_decoder_waits_for_m12c(self):
        cfg = dataclasses.replace(tcfg_of(equiv_config("dense")), is_encoder_decoder=True,
                                  enc_layers=1, dec_layers=1)
        for make in (serve_step.make_prefill_step, serve_step.make_decode_step,
                     serve_step.make_cache_factory):
            with pytest.raises(NotImplementedError, match="M12c"):
                make(cfg, device="cpu")


class TestDeviceDefaults:
    @pytest.fixture
    def no_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def test_entry_points_raise_without_a_gpu(self, no_cuda):
        cfg = tcfg_of(equiv_config("dense"))
        for call in (lambda: serve_step.make_prefill_step(cfg),
                     lambda: serve_step.make_decode_step(cfg),
                     lambda: serve_step.make_cache_factory(cfg),
                     lambda: DecoderLM(cfg).init(0),
                     lambda: DecoderLM(cfg).init_cache(1, 4),
                     lambda: params_from_numpy({"w": np.zeros(2, np.float32)})):
            with pytest.raises(RuntimeError, match="CUDA"):
                call()

    def test_cpu_is_explicit(self):
        cfg = tcfg_of(equiv_config("dense"))
        p = DecoderLM(cfg).init(0, device="cpu")
        cache = serve_step.make_cache_factory(cfg, device="cpu")(1, 4)
        assert p["embed"]["table"].device.type == "cpu"
        assert cache["len"].device.type == "cpu"


class TestBf16Carry:
    def test_reference_bf16_init_crosses_bit_for_bit(self):
        jcfg = dataclasses.replace(jconfigs.get_arch("qwen2-7b").smoke, dtype="bfloat16")
        host = jax.device_get(JDecoderLM(jcfg).init(0))
        tp = params_from_numpy(host, device="cpu")
        n = 0
        for (path, want), (tpath, got) in zip(_leaves_with_paths(host), _leaves_with_paths(tp)):
            assert path == tpath
            if want is None:
                assert got is None
                continue
            assert want.dtype == ml_dtypes.bfloat16 and got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                          want.view(np.uint16))
            n += 1
        assert n > 10

    def test_params_to_numpy_gives_bf16_bits_with_the_name_recorded(self):
        jcfg = dataclasses.replace(jconfigs.get_arch("tinyllama-1.1b").smoke, dtype="bfloat16")
        host = jax.device_get(JDecoderLM(jcfg).init(0))
        tp = params_from_numpy(host, device="cpu")
        back = params_to_numpy(tp)
        for (_, want), (_, got), (_, t) in zip(_leaves_with_paths(host),
                                               _leaves_with_paths(back), _leaves_with_paths(tp)):
            if want is None:
                assert got is None
                continue
            assert got.dtype == np.uint16 and got.dtype.metadata == {"dtype": "bfloat16"}
            assert got.dtype == BF16_BITS
            np.testing.assert_array_equal(got.view(ml_dtypes.bfloat16).view(np.uint16),
                                          want.view(np.uint16))
            again = params_from_numpy({"x": got}, device="cpu")["x"]
            assert again.dtype == torch.bfloat16 and torch.equal(again, t)

    def test_fp32_leaves_and_scalars_round_trip(self):
        jcfg = equiv_config("windowed")
        host = jax.device_get(JDecoderLM(jcfg).init(0))
        back = params_to_numpy(params_from_numpy(host, device="cpu"))
        for (_, want), (_, got) in zip(_leaves_with_paths(host), _leaves_with_paths(back)):
            assert got.dtype == want.dtype and np.array_equal(got, want)
        cache = params_from_numpy(jax.device_get(JDecoderLM(jcfg).init_cache(2, 4)),
                                  device="cpu")
        assert cache["len"].dtype == torch.int32 and cache["len"].dim() == 0
