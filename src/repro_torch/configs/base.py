"""Architecture config system (a copy of ``repro.configs.base``).

The port keeps its own copy so that it imports nothing of the JAX package.
Every assigned architecture is a frozen :class:`ArchConfig`.  Layer stacks are
described as a repeating ``pattern_unit`` (a tuple of block kinds) scanned
``n_units`` times plus an unrolled ``tail`` — this keeps HLO size bounded for
deep configs (61-layer / 1T-param MoE): the parameters of repeated units
are stacked on a leading axis.

Block kinds
-----------
``attn``   global (full, causal for decoders) attention + FFN
``local``  sliding-window attention + FFN
``rglru``  RG-LRU gated linear recurrence block (Griffin) + FFN
``rwkv``   RWKV6 time-mix + channel-mix pair
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

BLOCK_KINDS = ("attn", "local", "rglru", "rwkv")


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    aux_loss: float = 1e-2


@dataclasses.dataclass(frozen=True)
class EncoderSpec:
    """Encoder tower for enc-dec models (whisper).  The modality frontend is a
    STUB per the assignment: inputs are precomputed frame embeddings."""
    n_layers: int
    n_ctx: int           # number of frames after the (stubbed) conv frontend
    d_model: int
    n_heads: int
    d_ff: int


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    # layer stack as scanned pattern + unrolled tail
    pattern_unit: Tuple[str, ...]
    n_units: int
    tail: Tuple[str, ...] = ()

    # attention details
    local_window: int = 0            # sliding-window size for "local" blocks
    use_rope: bool = True            # False: absolute positions (whisper)
    rope_theta: float = 10_000.0
    rope_theta_local: Optional[float] = None   # separate theta for local blocks
    qkv_bias: bool = False
    qk_norm: bool = False            # gemma3-style RMSNorm on q/k
    attn_softcap: float = 0.0
    final_softcap: float = 0.0

    # ffn / norm
    ffn_kind: str = "swiglu"         # swiglu | geglu | gelu (2-matmul MLP)
    norm_type: str = "rms"           # rms | layer
    tied_embeddings: bool = True
    embed_scale: bool = False        # gemma-style sqrt(d_model) input scaling

    # MoE
    moe: Optional[MoESpec] = None

    # RG-LRU (hybrid family)
    rnn_width: int = 0
    conv_width: int = 4

    # enc-dec (audio family)
    encoder: Optional[EncoderSpec] = None
    max_target_len: int = 448        # whisper decoder architectural cap

    # vlm stub frontend
    n_media_tokens: int = 0          # precomputed patch embeddings prepended

    # capability flags (drive shape applicability)
    subquadratic: bool = False       # may run long_500k
    is_decoder: bool = True

    source: str = ""                 # provenance tag from the assignment table

    def __post_init__(self):
        for k in self.pattern_unit + self.tail:
            assert k in BLOCK_KINDS, k
        assert self.stack_n_layers == self.n_layers, (
            f"{self.name}: pattern covers {self.stack_n_layers} layers, "
            f"declared {self.n_layers}")

    # --- derived -----------------------------------------------------------
    @property
    def stack_n_layers(self) -> int:
        return len(self.pattern_unit) * self.n_units + len(self.tail)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up so the vocab dim is shardable over 16-way TP."""
        m = 2048
        return ((self.vocab + m - 1) // m) * m

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks), used for 6·N·D
        roofline maths and HBM napkin checks."""
        n = self.padded_vocab * self.d_model          # embed
        if not self.tied_embeddings:
            n += self.padded_vocab * self.d_model     # unembed
        kinds = list(self.pattern_unit) * self.n_units + list(self.tail)
        for k in kinds:
            n += self._block_params(k)
        if self.encoder is not None:
            e = self.encoder
            per = (4 * e.d_model * e.n_heads * (e.d_model // e.n_heads)
                   + 2 * e.d_model * e.d_ff + 4 * e.d_model)
            n += e.n_layers * per + e.n_ctx * e.d_model
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        kinds = list(self.pattern_unit) * self.n_units + list(self.tail)
        moe_blocks = sum(1 for k in kinds if k in ("attn", "local"))
        per_expert = 3 * self.d_model * self.moe.d_ff_expert
        dead = moe_blocks * (self.moe.n_experts - self.moe.top_k) * per_expert
        return full - dead

    def _block_params(self, kind: str) -> int:
        D, H, K, hd, F = (self.d_model, self.n_heads, self.n_kv_heads,
                          self.head_dim, self.d_ff)
        norms = 2 * D
        if kind in ("attn", "local"):
            attn = D * H * hd + 2 * D * K * hd + H * hd * D
            if self.qkv_bias:
                attn += (H + 2 * K) * hd
            if self.moe is not None:
                ffn = (self.moe.n_experts * 3 * D * self.moe.d_ff_expert
                       + D * self.moe.n_experts)
            elif self.ffn_kind in ("swiglu", "geglu"):
                ffn = 3 * D * F
            else:
                ffn = 2 * D * F
            return attn + ffn + norms
        if kind == "rglru":
            W = self.rnn_width
            # linear-in / gate-in (D->W each), linear-out (W->D), conv1d,
            # RG-LRU input & recurrence gates (block-diagonal, per-head):
            rec = 2 * D * W + W * D + self.conv_width * W
            rec += 2 * (W * W // self.n_heads) + W  # a_gate + x_gate + Lambda
            ffn = 3 * D * F if self.ffn_kind in ("swiglu", "geglu") else 2 * D * F
            return rec + ffn + norms
        if kind == "rwkv":
            # time-mix: r,k,v,g,o projections + lora mixers; channel-mix: 2 mats
            tm = 5 * D * D + 6 * 32 * 2 * D + 64 * D * 2 + 2 * D
            cm = 2 * D * self.d_ff
            return tm + cm + norms
        raise ValueError(kind)

    def block_kinds(self) -> Tuple[str, ...]:
        return tuple(self.pattern_unit) * self.n_units + tuple(self.tail)


_REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    # import side-effect registration
    from repro_torch.configs import ALL_ARCHS  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs():
    from repro_torch.configs import ALL_ARCHS  # noqa: F401
    return dict(_REGISTRY)


def scaled_down(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Reduced config of the same family for CPU smoke tests."""
    small = dict(
        d_model=min(cfg.d_model, 64),
        n_heads=min(cfg.n_heads, 4),
        n_kv_heads=min(cfg.n_kv_heads, 2),
        head_dim=min(cfg.head_dim, 16),
        d_ff=min(cfg.d_ff, 128),
        vocab=min(cfg.vocab, 512),
        n_units=min(cfg.n_units, 2),
        local_window=min(cfg.local_window, 32) if cfg.local_window else 0,
        rnn_width=min(cfg.rnn_width, 64) if cfg.rnn_width else 0,
        n_media_tokens=min(cfg.n_media_tokens, 8) if cfg.n_media_tokens else 0,
    )
    small["n_kv_heads"] = min(small["n_kv_heads"], small["n_heads"])
    if cfg.n_heads % cfg.n_kv_heads == 0:
        # preserve GQA grouping property
        small["n_heads"] = small["n_kv_heads"] * min(cfg.q_per_kv, 2)
    if cfg.moe is not None:
        small["moe"] = MoESpec(n_experts=min(cfg.moe.n_experts, 8),
                               top_k=min(cfg.moe.top_k, 2),
                               d_ff_expert=min(cfg.moe.d_ff_expert, 64),
                               capacity_factor=cfg.moe.capacity_factor)
    small.update(overrides)
    if cfg.encoder is not None and "encoder" not in overrides:
        small["encoder"] = EncoderSpec(
            n_layers=2, n_ctx=32, d_model=small["d_model"],
            n_heads=small["n_heads"], d_ff=small["d_ff"])
    small["n_layers"] = (len(cfg.pattern_unit) * small["n_units"]
                         + len(cfg.tail))
    return dataclasses.replace(cfg, **small)
