"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144.
5:1 local(sliding-window):global attention, 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=10240, vocab=262144,
    attn_pattern=("sw", "sw", "sw", "sw", "sw", "full"), window=1024,
    rope_theta=1_000_000.0, mlp_type="gated",
    # long_500k runs: 5/6 of layers are window-bounded; global-layer KV is
    # sequence-sharded over the mesh in the reference.
    source="hf:google/gemma-3-1b-pt; unverified",
)
