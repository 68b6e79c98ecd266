"""qwen3-8b [hf:Qwen/Qwen3-8B]: 36L d_model=4096 32H (GQA kv=8) d_ff=12288
vocab=151936 — qk_norm, GQA, no qkv bias."""

from repro_torch.configs.lm_common import lm_archdef
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="qwen3-8b",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=12288,
    vocab=151936,
    qk_norm=True,
    qkv_bias=False,
    rope_theta=1e6,
)

ARCH = lm_archdef(CONFIG, notes="dense GQA with qk_norm [hf:Qwen/Qwen3-8B]")
