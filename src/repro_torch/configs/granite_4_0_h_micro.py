"""granite-4.0-h-micro [hybrid stack]: 40L d_model=2048, Mamba-2 mixers
(64 heads x 64, d_state 128, one group, conv 4) with a GQA attention
mixer (32H, kv=8, head_dim 64, NoPE, softmax scale 1/64) at layers 5,
15, 25 and 35, a SiLU-gated MLP of width 8192 after every mixer, vocab
100352 with a tied head; µP multipliers: embedding x12, each sublayer's
output x0.22, logits / 8; RMSNorm eps 1e-5.
[https://huggingface.co/ibm-granite/granite-4.0-h-micro/blob/main/config.json]"""
from repro_torch.configs.base import ArchConfig

_pat = tuple("attention" if i == 5 else "ssm" for i in range(10))

CONFIG = ArchConfig(
    name="granite-4.0-h-micro", family="hybrid",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8,   # head_dim 64
    d_ff=8192, vocab=100352, mlp_type="gated",
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, conv_width=4,
    mixer_pattern=_pat, rope=False, attn_scale=0.015625,
    embed_scale=12.0, residual_scale=0.22, logit_divisor=8.0,
    norm_eps=1e-5,
    # prefill and decode of a stack of layer kinds are not ported
    skip_shapes=("prefill_32k", "decode_32k", "long_500k"),
    source="https://huggingface.co/ibm-granite/granite-4.0-h-micro/blob/"
           "main/config.json",
)
