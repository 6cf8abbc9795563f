"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — PARALLEL attention+mamba heads per layer.
3 full-attention layers (first/middle/last), rest sliding-window.
Meta-tokens omitted. [arXiv:2411.13676; hf]"""
from repro_torch.configs.base import ArchConfig
import dataclasses

_pat = tuple("full" if i in (0, 15, 31) else "sw" for i in range(32))

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab=32001,
    attn_pattern=_pat, window=1024, mlp_type="gated",
    ssm_state=16, ssm_head_dim=64, ssm_expand=2, parallel_ssm=True,
    rope_theta=10_000.0,
    source="arXiv:2411.13676; hf",
)
