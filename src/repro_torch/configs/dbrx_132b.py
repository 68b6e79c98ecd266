"""dbrx-132b [hf:databricks/dbrx-base]: 40L d_model=6144 48H (GQA kv=8)
MoE 16 experts top-4, expert d_ff=10752, vocab=100352."""

from repro_torch.configs.lm_common import lm_archdef
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="dbrx-132b",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=10752,
    vocab=100352,
    qk_norm=False,
    qkv_bias=False,
    rope_theta=5e5,
    moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=10752, n_shared=0,
                  first_dense_layers=0),
)

ARCH = lm_archdef(CONFIG, notes="16-expert top-4 MoE GQA "
                                "[hf:databricks/dbrx-base; unverified]")
