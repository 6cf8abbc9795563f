"""ArchConfig: one dataclass describing every assigned architecture, the
input-shape grid (train_4k / prefill_32k / decode_32k / long_500k), and the
reduced smoke variants. configs/<id>.py instantiate it.

PyTorch port of `repro.configs.base`: the same fields, shapes, smoke
reduction and parameter counts; `is_global_flags` returns a torch tensor
and `input_specs` returns tensors on the `meta` device (shape and dtype,
no storage) in place of `jax.ShapeDtypeStruct`s.
"""
from __future__ import annotations

import dataclasses

import torch

# The four assigned LM shapes: (seq_len, global_batch, kind)
SHAPES: dict[str, dict] = {
    "train_4k":    {"seq": 4096,    "batch": 256, "kind": "train"},
    "prefill_32k": {"seq": 32768,   "batch": 32,  "kind": "prefill"},
    "decode_32k":  {"seq": 32768,   "batch": 128, "kind": "decode"},
    "long_500k":   {"seq": 524288,  "batch": 1,   "kind": "decode"},
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | hybrid | audio | ssm | vlm
    n_layers: int
    d_model: int
    n_heads: int                    # 0 for attention-free (mamba2)
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    # attention pattern: cycled over layers; "sw" = sliding window, "full"
    attn_pattern: tuple = ("full",)
    window: int = 1024
    causal: bool = True
    rope_theta: float = 10_000.0
    mlp_type: str = "gated"         # gated (SiLU) | gelu | none
    norm_type: str = "rms"          # rms | layer
    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2 / hymba)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    parallel_ssm: bool = False      # hymba: attention + SSM heads in parallel
    # IO frontend
    frontend: str = "tokens"        # tokens | frames | patches
    frame_dim: int = 512            # audio stub: precomputed frame embedding dim
    n_patches: int = 256            # vlm stub: number of image patches
    patch_dim: int = 1152           # vlm stub: precomputed patch embedding dim
    tie_embeddings: bool = True
    # Port-only fields (the JAX package's ArchConfig has none; their
    # defaults leave the ten assigned archs as the reference runs them).
    # Layers of different kinds (granite-4.0-h): each layer's mixer,
    # "ssm" (Mamba-2) or "attention", cycled over the layers; each kind
    # keeps a stack of leaves of its own. () = the family's one block.
    mixer_pattern: tuple = ()
    rope: bool = True                # False: NoPE, no positional encoding
    attn_scale: float = 0.0         # softmax scale; 0 -> 1/sqrt(head_dim)
    embed_scale: float = 1.0        # the token embedding is multiplied by it
    residual_scale: float = 1.0     # each sublayer's output, before its add
    logit_divisor: float = 1.0      # the logits are divided by it
    norm_eps: float = 1e-6          # RMSNorm epsilon
    # which assigned shapes this arch skips (the reason beside each config)
    skip_shapes: tuple = ()
    # provenance
    source: str = ""

    # ------------------------------------------------------------- derived
    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def ssm_heads(self) -> int:
        return (self.ssm_expand * self.d_model) // self.ssm_head_dim

    @property
    def has_attention(self) -> bool:
        return self.n_heads > 0

    @property
    def has_ssm(self) -> bool:
        return self.ssm_state > 0

    def layer_kinds(self) -> list[str]:
        """Per-layer attention kind ('full'|'sw'|'ssm') cycling the pattern."""
        pat = self.attn_pattern
        return [pat[i % len(pat)] for i in range(self.n_layers)]

    def layer_mixers(self) -> list[str]:
        """Per-layer mixer kind cycling `mixer_pattern` ([] without one:
        every layer is the family's one block)."""
        pat = self.mixer_pattern
        return [pat[i % len(pat)] for i in range(self.n_layers)] if pat \
            else []

    def is_global_flags(self) -> torch.Tensor:
        """float32[L]: 1.0 where the layer uses FULL attention."""
        return torch.tensor([1.0 if k == "full" else 0.0
                             for k in self.layer_kinds()],
                            dtype=torch.float32)

    # --------------------------------------------------------------- shapes
    def shapes(self) -> dict[str, dict]:
        out = {}
        for name, s in SHAPES.items():
            if name in self.skip_shapes:
                continue
            if s["kind"] == "decode" and self.family == "audio":
                continue  # encoder-only: no autoregressive step
            out[name] = s
        return out

    def input_specs(self, shape_name: str, *, dtype=torch.bfloat16,
                    batch: int | None = None, seq: int | None = None
                    ) -> dict:
        """`meta`-device stand-ins for every model input (no allocation);
        `batch` / `seq` override the shape's."""
        s = SHAPES[shape_name]
        B, S = batch or s["batch"], seq or s["seq"]
        kind = s["kind"]
        i32 = torch.int32

        def sds(shape, dt):
            return torch.empty(shape, dtype=dt, device="meta")

        if self.frontend == "frames":       # audio: precomputed frame embeds
            x = {"frames": sds((B, S, self.frame_dim), dtype),
                 "labels": sds((B, S), i32)}
            return x
        if self.frontend == "patches":      # vlm: patch embeds + text tokens
            text = S - self.n_patches
            if kind == "train":
                return {"patches": sds((B, self.n_patches, self.patch_dim), dtype),
                        "tokens": sds((B, text), i32),
                        "labels": sds((B, text), i32)}
            if kind == "prefill":
                return {"patches": sds((B, self.n_patches, self.patch_dim), dtype),
                        "tokens": sds((B, text), i32)}
            return {"token": sds((B, 1), i32)}   # decode
        # plain token LM
        if kind == "train":
            return {"tokens": sds((B, S), i32), "labels": sds((B, S), i32)}
        if kind == "prefill":
            return {"tokens": sds((B, S), i32)}
        return {"token": sds((B, 1), i32)}       # decode: one new token

    # ---------------------------------------------------------------- smoke
    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            # a pattern of layer kinds keeps one whole period
            n_layers=min(self.n_layers, max(2, len(self.mixer_pattern))),
            d_model=128,
            n_heads=min(self.n_heads, 4) if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=32 if self.n_heads else 0,
            d_ff=max(self.d_ff and 256, 0),
            vocab=min(self.vocab, 512),
            n_experts=min(self.n_experts, 4),
            moe_top_k=min(self.moe_top_k, 2),
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=32 if self.ssm_state else 64,
            window=64,
            frame_dim=64 if self.frontend == "frames" else self.frame_dim,
            n_patches=8 if self.frontend == "patches" else self.n_patches,
            patch_dim=64 if self.frontend == "patches" else self.patch_dim,
        )

    # -------------------------------------------------------------- counting
    def param_count(self) -> int:
        """Approximate parameter count (embedding + per-layer)."""
        d, L = self.d_model, self.n_layers
        n = self.vocab * d                              # embed (tied head)
        if not self.tie_embeddings:
            n += self.vocab * d
        hd = self.head_dim_
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d
        din = self.ssm_expand * self.d_model
        ssm = d * (2 * din + 2 * self.ssm_state) + din * d \
            + self.conv_width * (din + 2 * self.ssm_state)
        per = 0
        if self.mixer_pattern:                   # each layer its own mixer
            mixers = self.layer_mixers()
            n += (mixers.count("attention") * attn
                  + mixers.count("ssm") * ssm)
        else:
            per += attn * self.has_attention + ssm * self.has_ssm
        if self.n_experts:
            per += d * self.n_experts \
                + self.n_experts * 3 * d * self.d_ff
        elif self.mlp_type == "gated":
            per += 3 * d * self.d_ff
        elif self.mlp_type == "gelu":
            per += 2 * d * self.d_ff
        per += 2 * d                                     # norms
        return n + L * per

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        full = self.param_count()
        moe_all = L * self.n_experts * 3 * d * self.d_ff
        moe_act = L * self.moe_top_k * 3 * d * self.d_ff
        return full - moe_all + moe_act
