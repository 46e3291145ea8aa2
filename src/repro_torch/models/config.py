"""Model configuration for all assigned architectures.

One frozen dataclass covers the five families (dense / moe / vlm / hybrid /
ssm / encdec): family-specific fields are zero/None when unused. Exact
hyper-parameters per architecture live in ``repro_torch/configs/<id>.py``.
A copy of the reference's ``models/config.py`` (pure Python): the port
imports nothing of ``repro``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | vlm | hybrid | ssm | encdec
    n_layers: int
    d_model: int
    n_heads: int                # 0 for attention-free (ssm)
    n_kv_heads: int
    d_ff: int                   # dense FFN dim (per-expert dim for MoE)
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0   # shared experts with the same d_ff
    top_k: int = 0
    capacity_factor: float = 1.25

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 128        # SSD chunk length
    attn_every: int = 0         # hybrid: shared attn block every k layers

    # encoder-decoder
    enc_layers: int = 0

    # modality frontend stub (precomputed embeddings per the assignment)
    frontend: Optional[str] = None   # None | 'vision_stub' | 'audio_stub'
    frontend_len: int = 0            # patches / frames per example

    # compute
    dtype: str = "bfloat16"     # activation/compute dtype
    param_dtype: str = "float32"

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def vocab_padded(self) -> int:
        """Embedding/head tables padded to a multiple of 256 so the vocab dim
        shards over model=16 (MaxText-style); logits at padded positions are
        masked to -inf in the loss/decode (exact semantics preserved)."""
        return (self.vocab + 255) // 256 * 256

    @property
    def d_inner(self) -> int:            # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM/hybrid decode)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab
        hd = self.head_dim
        att = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d if self.n_heads else 0
        mlp_dense = 3 * d * ff
        n = 0
        if self.family in ("dense", "vlm"):
            n = self.n_layers * (att + mlp_dense + 2 * d)
        elif self.family == "moe":
            # expert tables are padded to a multiple of the EP axis (16) so
            # expert parallelism always applies (models/moe.padded_experts)
            e_pad = -(-self.n_experts // 16) * 16
            moe = e_pad * 3 * d * ff + d * self.n_experts \
                + self.n_shared_experts * 3 * d * ff
            n = self.n_layers * (att + moe + 2 * d)
        elif self.family == "ssm":
            blk = self._ssm_block_params()
            n = self.n_layers * (blk + d)
        elif self.family == "hybrid":
            blk = self._ssm_block_params()
            shared = att + mlp_dense + 2 * d
            n = self.n_layers * (blk + d) + shared
        elif self.family == "encdec":
            enc = self.enc_layers * (att + mlp_dense + 2 * d)
            dec = self.n_layers * (2 * att + mlp_dense + 3 * d)
            n = enc + dec
        n += V * d * (1 if self.tie_embeddings else 2) + d
        if self.family in ("vlm",) :
            n += self.d_model * self.d_model  # projector stub
        return n

    def _ssm_block_params(self) -> int:
        d, di, N = self.d_model, self.d_inner, self.ssm_state
        H = self.ssm_heads
        g = 1  # single B/C group
        in_proj = d * (2 * di + 2 * g * N + H)
        return in_proj + self.ssm_conv * (di + 2 * g * N) + H * 2 \
            + di * d + di

    def active_param_count(self) -> int:
        """MoE: params touched per token (for 6·N_active·D roofline)."""
        if self.family != "moe":
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        hd = self.head_dim
        att = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        act_moe = (self.top_k + self.n_shared_experts) * 3 * d * ff \
            + d * self.n_experts
        n = self.n_layers * (att + act_moe + 2 * d)
        n += self.vocab * d * 2 + d
        return n


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str    # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def cell_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether an (arch × shape) dry-run cell applies (assignment rules)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("long_500k requires sub-quadratic attention; "
                       f"{cfg.name} is full-attention (skip per assignment)")
    return True, ""
