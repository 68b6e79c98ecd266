"""qwen2-1.5b [arXiv:2407.10671]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — GQA with QKV bias."""

from repro_torch.configs.lm_common import lm_archdef
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="qwen2-1.5b",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_head=128,
    d_ff=8960,
    vocab=151936,
    qk_norm=False,
    qkv_bias=True,
    rope_theta=1e6,
)

ARCH = lm_archdef(CONFIG, notes="dense GQA with QKV bias [arXiv:2407.10671]")
