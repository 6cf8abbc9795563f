"""gemma3-27b [dense]: 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144. 5:1 local:global, 128k. [hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=21504, vocab=262144,
    attn_pattern=("sw", "sw", "sw", "sw", "sw", "full"), window=1024,
    rope_theta=1_000_000.0, mlp_type="gated",
    source="hf:google/gemma-3-1b-pt; unverified",
)
