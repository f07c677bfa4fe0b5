"""Architecture configuration schema + registry (the port's own copy).

Mirrors ``repro/configs/base.py`` field for field, so a config read by
either package describes the same model.  Every architecture of the JAX
package has a module here; ``get_config`` imports
``repro_torch.configs.<arch>`` on first use.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

#: the architectures, in the JAX package's order
ARCH_IDS = (
    "minitron-8b",
    "deepseek-67b",
    "smollm-360m",
    "h2o-danube-3-4b",
    "whisper-medium",
    "kimi-k2-1t-a32b",
    "qwen3-moe-235b-a22b",
    "mamba2-370m",
    "recurrentgemma-9b",
    "internvl2-76b",
)

# Layer kinds usable in ``layer_pattern`` (the JAX package's vocabulary,
# all of which the port's model code serves):
#   'attn'  GQA attention (+ SwiGLU MLP), window = cfg.window
#   'local' GQA attention with window = cfg.local_window (+ MLP)
#   'moe'   GQA attention + MoE FFN
#   'ssm'   Mamba-2 (SSD) mixer, no MLP
#   'rec'   RG-LRU recurrent block + MLP
LAYER_KINDS = ("attn", "local", "moe", "ssm", "rec")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense|moe|ssm|hybrid|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    layer_pattern: Tuple[str, ...] = ("attn",)
    tail_pattern: Tuple[str, ...] = ()
    window: int = 0                 # SWA width for 'attn' layers
    local_window: int = 0           # window for 'local' layers
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM
    ssm_state: int = 0
    # hybrid
    lru_width: int = 0
    # encoder-decoder (audio)
    encoder_layers: int = 0
    encoder_seq: int = 0
    # vlm
    prefix_tokens: int = 0
    rope_theta: float = 10000.0
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    use_rope: bool = True
    notes: str = ""

    def __post_init__(self):
        if (self.n_layers - len(self.tail_pattern)) \
                % len(self.layer_pattern) != 0:
            raise ValueError((self.name, self.n_layers, self.layer_pattern,
                              self.tail_pattern))
        for kind in self.layer_pattern + self.tail_pattern:
            if kind not in LAYER_KINDS:
                raise ValueError(f"unknown layer kind {kind!r}")

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // max(self.n_heads, 1)

    @property
    def repeats(self) -> int:
        return (self.n_layers - len(self.tail_pattern)) \
            // len(self.layer_pattern)

    @property
    def all_kinds(self) -> Tuple[str, ...]:
        return self.layer_pattern + self.tail_pattern

    @property
    def attention_free(self) -> bool:
        return all(k == "ssm" for k in self.all_kinds)

    @property
    def sub_quadratic(self) -> bool:
        """True if no layer needs an unbounded KV cache (long_500k gate)."""
        for k in self.all_kinds:
            if k == "attn" and self.window == 0:
                return False
            if k == "moe" and self.window == 0:
                return False
            if k == "local" and self.local_window == 0:
                return False
        return True

    # ----- parameter / FLOP accounting -----

    def _attn_params(self) -> int:
        return self.d_model * self.hd * (2 * self.n_heads
                                         + 2 * self.n_kv_heads)

    def _mlp_params(self) -> int:
        return 3 * self.d_model * self.d_ff

    def _layer_params(self, kind: str, active_only: bool = False) -> int:
        if kind in ("attn", "local"):
            return self._attn_params() + self._mlp_params()
        if kind == "moe":
            experts = self.top_k if active_only else self.n_experts
            return self._attn_params() + self.d_model * self.n_experts \
                + experts * 3 * self.d_model * self.d_ff
        if kind == "ssm":
            from repro_torch.models.mamba2 import dims
            dd = dims(self.d_model, self.ssm_state)
            return (self.d_model * dd["proj_out"]
                    + dd["d_inner"] * self.d_model)
        if kind == "rec":
            w = self.lru_width or self.d_model
            return (self.d_model * 2 * w + 2 * w * w + w * self.d_model
                    + self._mlp_params())
        raise ValueError(kind)

    def param_count(self, active_only: bool = False) -> int:
        unit = sum(self._layer_params(k, active_only)
                   for k in self.layer_pattern)
        total = unit * self.repeats
        total += sum(self._layer_params(k, active_only)
                     for k in self.tail_pattern)
        total += 2 * self.vocab * self.d_model          # embed + lm head
        if self.encoder_layers:
            total += self.encoder_layers * (
                self._attn_params() + 2 * self.d_model * self.d_ff)
            total += self.n_layers * self._attn_params()
        return total

    def model_flops(self, tokens: int, *, training: bool) -> float:
        """6*N*D (train) / 2*N*D (inference) with N = active params."""
        n = self.param_count(active_only=True)
        return (6.0 if training else 2.0) * n * tokens


_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        mod = name.replace("-", "_").replace(".", "_")
        importlib.import_module(f"repro_torch.configs.{mod}")
    return _REGISTRY[name]


def get_smoke_config(name: str) -> ModelConfig:
    get_config(name)                      # ensure module imported
    return _REGISTRY[name + "-smoke"]


def all_configs() -> Dict[str, ModelConfig]:
    for a in ARCH_IDS:
        get_config(a)
    return {a: _REGISTRY[a] for a in ARCH_IDS}
