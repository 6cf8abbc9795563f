"""hubert-xlarge [audio]: 48L d_model=1280 16H (MHA) d_ff=5120 vocab=504.
Encoder-only (no decode shapes). Modality frontend = STUB: input_specs()
provides precomputed frame embeddings [B, S, frame_dim].
[arXiv:2106.07447; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
    d_ff=5120, vocab=504,
    attn_pattern=("full",), causal=False, mlp_type="gelu", norm_type="layer",
    frontend="frames", frame_dim=512, tie_embeddings=False,
    skip_shapes=("decode_32k", "long_500k"),  # encoder-only: no decode
    source="arXiv:2106.07447; unverified",
)
