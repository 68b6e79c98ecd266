"""deepseek-v2-236b [arXiv:2405.04434]: 60L d_model=5120 128H, MLA
(kv_lora=512, q_lora=1536, rope 64 + nope 128, v 128), MoE: 2 shared + 160
routed experts top-6, expert d_ff=1536, vocab=102400, first layer dense."""

from repro_torch.configs.lm_common import lm_archdef
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="deepseek-v2-236b",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_head=192,  # qk head dim (nope 128 + rope 64)
    d_ff=12288,  # dense layers (first_dense_layers) use 12288
    vocab=102400,
    attn="mla",
    q_lora=1536,
    kv_lora=512,
    rope_head_dim=64,
    nope_head_dim=128,
    v_head_dim=128,
    rope_theta=1e4,
    moe=MoEConfig(n_experts=160, top_k=6, d_ff_expert=1536, n_shared=2,
                  first_dense_layers=1),
)

ARCH = lm_archdef(CONFIG,
                  notes="MLA + fine-grained MoE (2 shared + 160 routed "
                        "top-6) [arXiv:2405.04434]")
