"""paligemma-3b [vlm]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=257216 — SigLIP + gemma decoder, prefix-LM over patches.
Vision frontend = STUB: input_specs() provides precomputed patch embeddings
[B, 256, patch_dim]. [arXiv:2407.07726; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab=257216,
    attn_pattern=("full",), mlp_type="gated",
    frontend="patches", n_patches=256, patch_dim=1152,
    rope_theta=10_000.0,
    skip_shapes=("long_500k",),   # full attention: unbounded KV
    source="arXiv:2407.07726; hf",
)
