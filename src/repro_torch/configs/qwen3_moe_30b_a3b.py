"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) d_ff(expert)=768
vocab=151936, MoE 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=768, vocab=151936,
    attn_pattern=("full",), mlp_type="gated",
    n_experts=128, moe_top_k=8,
    rope_theta=1_000_000.0,
    skip_shapes=("long_500k",),   # full attention: unbounded KV
    source="hf:Qwen/Qwen3-30B-A3B; hf",
)
