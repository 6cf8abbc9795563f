"""stablelm-3b [dense]: 32L d_model=2560 32H (kv=32, i.e. MHA) d_ff=6912
vocab=50304. [hf:stabilityai/stablelm-2-1_6b; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=6912, vocab=50304,
    attn_pattern=("full",), mlp_type="gated", norm_type="layer",
    rope_theta=10_000.0,
    skip_shapes=("long_500k",),   # full attention: unbounded KV
    source="hf:stabilityai/stablelm-2-1_6b; unverified",
)
