"""Model configuration system.

One :class:`ModelConfig` describes any of the six assigned architecture
families (dense / moe / ssm / hybrid / audio / vlm).  A model is a stack of
*periods*: a period is a short tuple of (mixer, ffn) layer descriptors that
repeats ``n_layers / len(period)`` times — period length 1 for homogeneous
stacks, 8 for Jamba's 1:7 attention:mamba interleave.  The period structure
is what lets the runtime ``lax.scan`` over stacked per-period parameters and
keep the HLO small enough to AOT-compile 80 (arch × shape × mesh) dry-runs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# mixer kinds: "attn" (GQA), "mla", "mamba", "rwkv", "none"
# ffn kinds:   "mlp" (SwiGLU), "gelu_mlp", "moe", "rwkv_cmix"


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora: int = 512
    q_lora: Optional[int] = None
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    # Mamba-1 selective SSM (Jamba's mixer)
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None  # default ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64   # rank of the data-dependent decay LoRA (Finch)
    tokenshift_lora: int = 32


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    period: Tuple[Tuple[str, str], ...] = (("attn", "mlp"),)
    qkv_bias: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    rope: str = "rope"               # rope | mrope | none
    rope_theta: float = 1e6
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    enc_dec: bool = False            # whisper-style encoder-decoder
    n_enc_layers: int = 0
    sliding_window: Optional[int] = None  # used by long_500k attention variant
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "silu"
    # source citation for the numbers above
    source: str = ""

    # ---------------- derived ----------------
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def n_periods(self) -> int:
        assert self.n_layers % len(self.period) == 0, (self.name, self.n_layers, len(self.period))
        return self.n_layers // len(self.period)

    @property
    def attn_free(self) -> bool:
        return all(m not in ("attn", "mla") for m, _ in self.period)

    @property
    def has_state_mixer(self) -> bool:
        return any(m in ("mamba", "rwkv") for m, _ in self.period)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab
        total = V * d  # embed
        if not self.tie_embeddings:
            total += d * V
        per_period = 0
        for mixer, ffn in self.period:
            per_period += 2 * d  # two pre-norms
            if mixer == "attn":
                hd = self.hd
                per_period += d * self.n_heads * hd + 2 * d * self.n_kv * hd + self.n_heads * hd * d
                if self.qkv_bias:
                    per_period += (self.n_heads + 2 * self.n_kv) * hd
            elif mixer == "mla":
                m = self.mla
                qk = m.qk_nope_dim + m.qk_rope_dim
                per_period += d * self.n_heads * qk          # W_q
                per_period += d * m.kv_lora + d * m.qk_rope_dim
                per_period += m.kv_lora * self.n_heads * (m.qk_nope_dim + m.v_head_dim)
                per_period += self.n_heads * m.v_head_dim * d
            elif mixer == "mamba":
                s = self.ssm
                di = s.expand * d
                dtr = s.dt_rank or -(-d // 16)
                per_period += d * 2 * di + di * s.d_conv + di * (dtr + 2 * s.d_state)
                per_period += dtr * di + di * s.d_state + di + di * d
            elif mixer == "rwkv":
                per_period += 4 * d * d + d * d  # r,k,v,o,gate
                per_period += 2 * d * self.rwkv.decay_lora  # decay lora
            if ffn == "mlp":
                per_period += 3 * d * ff
            elif ffn == "gelu_mlp":
                per_period += 2 * d * ff
            elif ffn == "moe":
                mo = self.moe
                per_period += d * mo.n_experts
                per_period += mo.n_experts * 3 * d * mo.d_expert
                per_period += mo.n_shared * 3 * d * mo.d_expert
            elif ffn == "rwkv_cmix":
                per_period += d * int(3.5 * d) + int(3.5 * d) * d
        total += per_period * self.n_periods
        if self.enc_dec:
            # encoder blocks (attn + gelu_mlp) + decoder cross-attn
            hd = self.hd
            enc = self.n_enc_layers * (2 * d + d * self.n_heads * hd * 2 +
                                       2 * d * self.n_kv * hd + 2 * d * ff + 2 * d)
            cross = self.n_layers * (d + d * self.n_heads * hd + 2 * d * self.n_kv * hd +
                                     self.n_heads * hd * d)
            total += enc + cross
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k + shared only)."""
        if self.moe is None:
            return self.param_count()
        mo = self.moe
        moe_layers = sum(1 for _, f in self.period if f == "moe") * self.n_periods
        inactive = (mo.n_experts - mo.top_k) * 3 * self.d_model * mo.d_expert * moe_layers
        return self.param_count() - inactive

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: <=2 periods, d_model<=256, <=4 experts."""
        d = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        ratio = max(1, self.n_heads // max(self.n_kv, 1))
        n_kv = max(1, n_heads // min(ratio, n_heads))
        hd = 64
        moe = None
        if self.moe:
            moe = dataclasses.replace(self.moe, n_experts=4, top_k=min(self.moe.top_k, 2),
                                      d_expert=128, n_shared=min(self.moe.n_shared, 1))
        mla = dataclasses.replace(self.mla, kv_lora=64, qk_nope_dim=32, qk_rope_dim=16,
                                  v_head_dim=32) if self.mla else None
        rwkv = dataclasses.replace(self.rwkv, head_dim=32, decay_lora=16) if self.rwkv else None
        n_layers = len(self.period) * min(self.n_periods, 2 if len(self.period) == 1 else 1)
        sec = self.mrope_sections
        if self.rope == "mrope" and sum(sec) != hd // 2:
            s = hd // 2
            sec = (s // 4, s // 4 + s // 8, s - s // 4 - (s // 4 + s // 8))
        return dataclasses.replace(
            self, name=self.name + "-reduced", n_layers=n_layers, d_model=d,
            n_heads=n_heads, n_kv=n_kv, head_dim=hd, d_ff=min(self.d_ff, 512),
            vocab=min(self.vocab, 1024), moe=moe, mla=mla, rwkv=rwkv,
            mrope_sections=sec,
            n_enc_layers=min(self.n_enc_layers, 2), sliding_window=None,
        )


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
