"""Unified architecture configuration covering every assigned family.

A copy of ``repro.models.config`` (framework-free): every field, the
sharding knobs included, which do nothing on one device, as the
reference's do without a mesh."""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads

    # -- attention ---------------------------------------------------------
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    # per-layer sliding window; 0 = full/global attention at that layer.
    # 'window_pattern' cycles over layers, e.g. (1024,)*5 + (0,) for
    # gemma3's 5 local : 1 global.
    window_pattern: Tuple[int, ...] = (0,)
    logit_softcap: float = 0.0

    # -- MoE ----------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0    # deepseek: leading dense-FFN layers
    router_scale: float = 1.0
    capacity_factor: float = 1.25

    # -- MLA (deepseek) -------------------------------------------------------
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # -- recurrent families ----------------------------------------------------
    # block pattern cycled over depth, e.g. ("rglru","rglru","attn").
    block_pattern: Tuple[str, ...] = ("attn",)
    conv_width: int = 4            # RG-LRU temporal conv
    rglru_dim: int = 0             # recurrence width (0 -> d_model)

    # -- encoder-decoder ---------------------------------------------------------
    is_encoder_decoder: bool = False
    enc_layers: int = 0
    dec_layers: int = 0

    # -- misc -----------------------------------------------------------------
    modality: str = "text"         # text | vision | audio (frontend stubs)
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # activation checkpointing policy used by train_step: none|full|dots
    remat: str = "full"
    # Unroll the over-layers scan.  False for fast compiles (deliverable-e
    # compilability sweep); True for the roofline metrics sweep — XLA cost
    # analysis counts a while body ONCE, so scanned models under-report
    # FLOPs and in-loop collective bytes by the trip count.
    scan_unroll: bool = False

    # ---- perf-iteration knobs (EXPERIMENTS.md §Perf) -----------------------
    # Remat each flash-attention KV chunk: the pure-JAX flash scan is
    # memory-lean in forward but its BACKWARD saves per-chunk softmax
    # residuals (O(S·chunk·heads) fp32 per layer) — checkpointing the
    # chunk body recomputes them instead.
    flash_remat: bool = False
    # Pad embedding/lm-head vocab to a multiple (0 = off).  Non-divisible
    # vocabs (granite 49155, seamless 256206) otherwise fall back to
    # replicated logits on the tensor axis — padding restores the shard.
    vocab_pad_multiple: int = 0
    # Keep MoE dispatch buffers sharded (experts on 'model', capacity on
    # 'data') via explicit constraints instead of letting GSPMD replicate
    # through the sort/scatter pipeline.
    moe_shard_constraints: bool = False
    # Block-local MoE dispatch: split tokens into N blocks (= data-axis
    # size) and sort/route WITHIN each block, with the block dim pinned
    # to 'data'.  Gathers/scatters become shard-local; only the
    # (block x expert) reshard moves bytes — the all-to-all pattern a
    # hand-written shard_map MoE would produce.  0 = global dispatch.
    moe_block_dispatch: int = 0
    # Decode cells: shard the KV-cache SEQUENCE dim over the tensor axis
    # (flash-decoding-style distributed softmax) instead of heads/head_dim
    # — kills the involuntary cache replication when kv_heads < tp.
    cache_seq_shard_tp: bool = False
    # Parameter layout: "fsdp_tp" shards weight contraction dims over the
    # data axis (ZeRO-3-style; GSPMD may turn every matmul into a partial
    # product + activation-sized all-reduce); "tp_only" keeps weights
    # megatron-sharded on the tensor axis only and leaves FSDP to the
    # optimizer moments (ZeRO-1) — weight-sized collectives instead of
    # activation-sized ones when the model fits 1/tp per chip.
    param_sharding_mode: str = "fsdp_tp"
    # Keep the embedding table's d_model dim unsharded: tied embeddings
    # are used twice per step and an fsdp-sharded d forces table-sized
    # all-gathers on every logits matmul.
    embed_unsharded_d: bool = False
    # Explicitly replicate attention q/k/v/scores on the tensor axis
    # (batch stays data-sharded).  For few-head archs (gemma3: 4H/1KV on
    # a 16-way tensor axis) GSPMD otherwise thrashes through involuntary
    # full rematerializations on every (H*hd)<->(H,hd) reshape; explicit
    # replication trades a little redundant attention compute (not the
    # bottleneck) for near-zero attention collectives.
    attn_replicated: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def layer_window(self) -> Tuple[int, ...]:
        """Resolved per-layer window (len == num_layers)."""
        p = self.window_pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    @property
    def layer_blocks(self) -> Tuple[str, ...]:
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    def param_count_estimate(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D and
        sanity checks against the instantiated tree)."""
        d, L = self.d_model, self.num_layers
        hd = self.head_dim
        total = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d
        blocks = self.layer_blocks
        for i in range(L if not self.is_encoder_decoder else 0):
            kind = blocks[i]
            if kind == "attn":
                if self.use_mla:
                    ql = self.q_lora_rank or d
                    total += d * ql + ql * self.num_heads * (self.qk_nope_dim + self.qk_rope_dim)
                    total += d * (self.kv_lora_rank + self.qk_rope_dim)
                    total += self.kv_lora_rank * self.num_heads * (self.qk_nope_dim + self.v_head_dim)
                    total += self.num_heads * self.v_head_dim * d
                else:
                    total += d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
                    total += self.num_heads * hd * d
            elif kind == "rwkv":
                total += 5 * d * d + d * d  # r,k,v,g,w projections + output
                total += 2 * 3 * d * d      # channel mix
            elif kind == "rglru":
                rd = self.rglru_dim or d
                total += 2 * d * rd + rd * d + self.conv_width * rd + 2 * rd
            # FFN
            if self.is_moe and i >= self.first_dense_layers and kind == "attn":
                e = self.num_experts
                total += d * e  # router
                total += e * 3 * d * self.moe_d_ff
                total += self.num_shared_experts * 3 * d * self.moe_d_ff
            elif kind in ("attn", "rglru"):
                total += 3 * d * self.d_ff
        if self.is_encoder_decoder:
            for _ in range(self.enc_layers):
                total += 4 * d * d + 3 * d * self.d_ff
            for _ in range(self.dec_layers):
                total += 8 * d * d + 3 * d * self.d_ff
        return total

    def active_param_count_estimate(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        if not self.is_moe:
            return self.param_count_estimate()
        total = self.param_count_estimate()
        e, k = self.num_experts, self.experts_per_token
        L_moe = self.num_layers - self.first_dense_layers
        expert_params = 3 * self.d_model * self.moe_d_ff
        total -= L_moe * (e - k) * expert_params
        return total
