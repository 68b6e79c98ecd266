"""minitron-8b [arXiv:2407.14679]: 32L d_model=4096 32H (GQA kv=8)
d_ff=16384 vocab=256000 — width-pruned Nemotron-4."""

from repro_torch.configs.lm_common import lm_archdef
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="minitron-8b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=16384,
    vocab=256000,
    qk_norm=False,
    qkv_bias=False,
    rope_theta=1e4,
)

ARCH = lm_archdef(CONFIG, notes="pruned nemotron dense GQA [arXiv:2407.14679]")
