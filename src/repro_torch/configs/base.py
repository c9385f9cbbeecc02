"""Config system: model architecture + input-shape configs.

A copy of ``repro.configs.base`` (pure Python; the copy is the port).

Every assigned architecture gets one module in this package defining a
``ModelConfig`` with the exact published hyperparameters; ``reduced()``
derives the tiny same-family config used by CPU smoke tests. Input shapes
(train_4k / prefill_32k / decode_32k / long_500k) are global and paired with
every arch (registry.py).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # -- attention structure --------------------------------------------
    window: int = 0  # sliding-window size for ALL attn layers; 0 = full
    local_global_period: int = 0  # p: (p-1) local + 1 global per block
    local_window: int = 1024  # window of "local" layers when period > 0
    use_qk_norm: bool = False

    # -- MoE --------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0  # per-expert hidden; 0 -> d_ff
    capacity_factor: float = 1.25

    # -- SSM (Mamba-2 / SSD) ----------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 128

    # -- VLM (cross-attention image layers; stub patch-embedding frontend) -
    cross_attn_period: int = 0  # every p-th layer is cross-attn; 0 = none
    n_image_tokens: int = 0

    # -- audio (stub frame-embedding frontend) -----------------------------
    embed_inputs: bool = False  # True: inputs are (B,S,D) embeddings

    # -- misc ---------------------------------------------------------------
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "float32"  # storage dtype (bf16 for dry-runs)
    tie_embeddings: bool = False
    loss_chunk: int = 0  # compute logits+CE in seq chunks; 0 = whole seq
    use_flash: bool = True  # Pallas kernels on no-grad paths
    kv_quant: bool = False  # int8 KV cache (per-position scales) for decode

    # ------------------------------------------------------------------

    def __post_init__(self):
        if self.family not in ("dense", "moe", "ssm", "hybrid", "audio", "vlm"):
            raise ValueError(f"unknown family {self.family}")
        if self.family != "ssm":
            if self.n_heads % max(self.n_kv_heads, 1):
                raise ValueError("n_heads must be divisible by n_kv_heads")

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim

    @property
    def attends_globally(self) -> bool:
        """True if any layer runs unwindowed full attention."""
        if self.family == "ssm":
            return False
        if self.local_global_period > 0:
            return True  # the global layers
        return self.window == 0

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic prefill & bounded/linear decode reads.

        SSM/hybrid: state-space decode is O(1). SWA: O(window) per token.
        local:global (gemma3): global layers are linear-per-token in decode
        and the config is assigned long_500k per DESIGN.md §6.
        """
        if self.family in ("ssm", "hybrid"):
            return True
        if self.window > 0:
            return True
        if self.local_global_period > 0:
            return True
        return False

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d = self.d_model
        total = self.vocab * d  # embedding
        if not self.tie_embeddings:
            total += self.vocab * d  # lm head
        for kind in self.layer_plan_flat():
            total += self._layer_params(kind)
        total += d  # final norm
        return total

    def _layer_params(self, kind: str) -> int:
        d = self.d_model
        hd = self.head_dim_
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
        mlp = 3 * d * self.d_ff
        norms = 2 * d
        if kind in ("attn", "local", "global"):
            return attn + mlp + norms
        if kind == "moe":
            ff = self.d_ff_expert or self.d_ff
            return attn + self.n_experts * 3 * d * ff + d * self.n_experts + norms
        if kind == "ssm":
            di, nh, ns = self.ssm_inner, self.ssm_heads, self.ssm_state
            in_proj = d * (2 * di + 2 * self.ssm_groups * ns + nh)
            conv_ch = di + 2 * self.ssm_groups * ns
            conv = conv_ch * self.ssm_conv + conv_ch  # taps + bias
            out = di * d + di + 3 * nh  # out_proj + gate norm + A,D,dt_bias
            mlp_p = 3 * d * self.d_ff if self.d_ff else 0
            return in_proj + conv + out + mlp_p + norms
        if kind == "hybrid":
            # attn(+mlp+2 norms) + ssm core(+mlp+2 norms) - one duplicate mlp
            # + 2 fuse scalars; the two extra fuse norms replace the ssm
            # branch's norm pair, so norm counts balance.
            return (self._layer_params("attn") + self._layer_params("ssm")
                    - 3 * d * self.d_ff + 2)
        if kind == "xattn":
            return attn + mlp + norms + 2  # + gates
        raise ValueError(kind)

    # -- layer plan ------------------------------------------------------

    def layer_plan(self) -> Tuple[Tuple[Tuple[str, ...], int], ...]:
        """Scan groups: ((kinds-per-block), repeats), preserving layer order.

        Kinds: attn | local | global | moe | ssm | hybrid | xattn.
        """
        L = self.n_layers
        if self.family == "ssm":
            return ((("ssm",), L),)
        if self.family == "hybrid":
            return ((("hybrid",), L),)
        if self.family == "moe":
            return ((("moe",), L),)
        if self.family == "vlm" and self.cross_attn_period > 0:
            p = self.cross_attn_period
            blocks, rem = divmod(L, p)
            plan = [(tuple(["attn"] * (p - 1) + ["xattn"]), blocks)]
            if rem:
                plan.append((("attn",), rem))
            return tuple(plan)
        if self.local_global_period > 0:
            p = self.local_global_period
            blocks, rem = divmod(L, p)
            plan = [(tuple(["local"] * (p - 1) + ["global"]), blocks)]
            if rem:
                plan.append((("local",), rem))
            return tuple(plan)
        return ((("attn",), L),)

    def layer_plan_flat(self) -> Tuple[str, ...]:
        out = []
        for kinds, reps in self.layer_plan():
            out.extend(list(kinds) * reps)
        return tuple(out)

    # -- reduced smoke config ---------------------------------------------

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        p = max(self.local_global_period, self.cross_attn_period)
        n_layers = max(2, p) if p else 2
        if self.cross_attn_period:
            n_layers = self.cross_attn_period
        kv = min(self.n_kv_heads, 2) or 1
        heads = max(2 * kv if self.n_heads != self.n_kv_heads else kv, kv)
        return dataclasses.replace(
            self,
            n_layers=n_layers,
            d_model=64,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=16,
            d_ff=128,
            d_ff_expert=32 if self.n_experts else 0,
            vocab=128,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            ssm_head_dim=8,
            ssm_chunk=8,
            n_image_tokens=8 if self.n_image_tokens else 0,
            local_window=8,
            window=8 if self.window else 0,
            dtype="float32",
            param_dtype="float32",
            loss_chunk=0,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def step_name(self) -> str:
        return {"train": "train_step", "prefill": "prefill_step",
                "decode": "serve_step"}[self.kind]


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}
