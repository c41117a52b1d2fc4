"""Architecture registry.

Every assigned architecture is a frozen :class:`ModelConfig`.  Configs carry
(1) the exact published hyper-parameters (cited in ``source``), and
(2) the serving metadata the paper's scheduler needs (total/active params,
a published quality score used as the "accuracy" axis of the paper's
model-selection experiments, and memory footprints for the cost model).

``reduced()`` derives the CPU-smoke variant of the same family
(<=2 layers, d_model<=512, <=4 experts) used by tests and examples.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Tuple

# ---------------------------------------------------------------------------
# Block kinds understood by the model code.
# ---------------------------------------------------------------------------
ATTN = "attn"          # global (full / causal) attention block
LOCAL_ATTN = "local"   # sliding-window attention block
RGLRU = "rglru"        # RG-LRU recurrent block (RecurrentGemma / Griffin)
RWKV = "rwkv"          # RWKV6 time-mix block (Finch)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # --- MoE ---------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    expert_d_ff: int = 0             # per-expert hidden dim (kimi style)
    moe_capacity_factor: float = 1.25

    # --- attention ----------------------------------------------------------
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    # layer pattern: repeating tuple of block kinds + optional tail
    block_pattern: Tuple[str, ...] = (ATTN,)
    tail_blocks: Tuple[str, ...] = ()
    local_window: int = 0            # window for LOCAL_ATTN blocks
    # sub-quadratic variant used ONLY for the long_500k shape on dense archs
    long_context_window: int = 4096

    # --- recurrent families ---------------------------------------------------
    rwkv_head_dim: int = 64
    rglru_width: int = 0             # 0 -> d_model (RG-LRU state width)

    # --- encoder-decoder (whisper) -------------------------------------------
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500          # whisper: 30 s of audio -> 1500 frames

    # --- modality frontend stub ----------------------------------------------
    frontend: str = "none"           # none | vision | audio
    # vlm: inputs are precomputed patch+text embeddings (B, S, d_model)
    # audio: encoder input is precomputed frame embeddings (B, enc_seq, d)

    # --- activation / norm flavour -------------------------------------------
    mlp: str = "swiglu"              # swiglu | gelu
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    tie_embeddings: bool = False

    # --- serving metadata (paper's model pool) -------------------------------
    quality: float = 0.0             # published aggregate quality (accuracy axis)
    source: str = ""

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def attention_free(self) -> bool:
        kinds = set(self.block_pattern) | set(self.tail_blocks)
        return ATTN not in kinds and LOCAL_ATTN not in kinds

    @property
    def subquadratic(self) -> bool:
        """True if decode state is O(1) or O(window) in sequence length."""
        kinds = set(self.block_pattern) | set(self.tail_blocks)
        return ATTN not in kinds

    def layer_kinds(self) -> Tuple[str, ...]:
        """Concrete per-layer block kinds, length == num_layers."""
        kinds = []
        while len(kinds) + len(self.tail_blocks) < self.num_layers:
            kinds.extend(self.block_pattern)
        kinds = kinds[: self.num_layers - len(self.tail_blocks)]
        kinds.extend(self.tail_blocks)
        assert len(kinds) == self.num_layers, (len(kinds), self.num_layers)
        return tuple(kinds)

    # --- parameter counting (analytical; checked against init in tests) ----
    def param_counts(self) -> Dict[str, int]:
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        counts: Dict[str, int] = {}
        counts["embed"] = v * d
        counts["lm_head"] = 0 if self.tie_embeddings else v * d

        def attn_params() -> int:
            p = d * nq * hd + 2 * d * nkv * hd + nq * hd * d
            if self.qkv_bias:
                p += nq * hd + 2 * nkv * hd
            return p

        def mlp_params(hidden: int) -> int:
            if self.mlp == "swiglu":
                return 3 * d * hidden
            return 2 * d * hidden

        def rwkv_params() -> int:
            # time-mix: r,k,v,g,o projections + data-dependent decay lora
            # + channel-mix (k,v,r) — matches RWKV6 structure.
            tm = 5 * d * d + 2 * d * 96  # decay lora rank ~96
            cm = 2 * d * ff_cm + d * d
            return tm + cm

        ff_cm = ff  # rwkv channel-mix hidden
        per_layer = 0
        total = counts["embed"] + counts["lm_head"]
        for kind in self.layer_kinds():
            if kind in (ATTN, LOCAL_ATTN):
                per_layer = attn_params()
                if self.num_experts:
                    e_ff = self.expert_d_ff or ff
                    per_layer += (
                        self.num_experts * mlp_params(e_ff)
                        + d * self.num_experts  # router
                    )
                else:
                    per_layer += mlp_params(ff)
            elif kind == RGLRU:
                w = self.rglru_width or d
                # conv1d(4) + gates + in/out proj + mlp
                per_layer = 2 * d * w + w * d + 4 * w + 2 * w * w // 8 + mlp_params(ff)
            elif kind == RWKV:
                per_layer = rwkv_params()
            total += per_layer + 2 * d  # two norms
        if self.is_encoder_decoder:
            # encoder layers: self-attn + mlp; decoder already counted; add
            # cross-attention for decoder layers.
            enc = self.encoder_layers * (attn_params() + mlp_params(ff) + 2 * d)
            xattn = self.num_layers * attn_params()
            total += enc + xattn
        counts["total"] = total
        return counts

    @property
    def params_total(self) -> int:
        """Exact parameter count from the model's parameter shapes (no
        allocation); the analytic ``param_counts()`` differs from the built
        model, so it is no stand-in."""
        from repro_torch.models.model import param_count

        return param_count(self)

    @property
    def params_active(self) -> int:
        """Active params per token (MoE uses top-k experts only)."""
        if not self.num_experts:
            return self.params_total
        d = self.d_model
        e_ff = self.expert_d_ff or self.d_ff
        per_expert = 3 * d * e_ff if self.mlp == "swiglu" else 2 * d * e_ff
        inactive = (self.num_experts - self.num_experts_per_tok) * per_expert
        return self.params_total - self.num_layers * inactive

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """CPU smoke variant of the same family (2 layers, d<=512, <=4 experts)."""
        d = min(self.d_model, 256)
        nq = min(self.num_heads, 4)
        nkv = max(1, min(self.num_kv_heads, nq))
        # preserve the GQA flavour: if original had grouped kv, keep ratio 2.
        if self.num_kv_heads < self.num_heads:
            nkv = max(1, nq // 2)
        pattern = self.block_pattern
        tail = ()
        n_layers = max(2, len(pattern))
        if self.is_encoder_decoder:
            n_layers = 2
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=n_layers,
            d_model=d,
            num_heads=nq,
            num_kv_heads=nkv,
            head_dim=d // nq,
            d_ff=min(self.d_ff, 512),
            expert_d_ff=min(self.expert_d_ff, 256) if self.expert_d_ff else 0,
            vocab_size=min(self.vocab_size, 1024),
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            num_experts_per_tok=min(self.num_experts_per_tok, 2)
            if self.num_experts_per_tok
            else 0,
            tail_blocks=tail,
            encoder_layers=2 if self.is_encoder_decoder else 0,
            encoder_seq=16 if self.is_encoder_decoder else self.encoder_seq,
            local_window=min(self.local_window, 8) if self.local_window else 0,
            long_context_window=64,
        )


# ---------------------------------------------------------------------------
# Input shapes (assigned).
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return get_config(name[: -len("-smoke")]).reduced()
    if name not in _REGISTRY:
        # late import so ``registry`` has no import-time jax dependency
        from repro_torch.configs import _load_all  # noqa: F401

        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown architecture {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_architectures():
    from repro_torch.configs import _load_all

    _load_all()
    return sorted(_REGISTRY)
