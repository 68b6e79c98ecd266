"""Model zoo of the port (the slices ported so far).

Families:
  - decoder-only LMs (transformer: dense GQA Qwen2, Qwen3, Minitron; MLA
    and MoE DeepSeek-V2; MoE DBRX — moe.py)
  - GNNs (gcn, pna, meshgraphnet, dimenet) — gnn/
  - RecSys (dlrm) — recsys/

Each model is an ``nn.Module`` built from its config, a device and a
``torch.Generator``; its family exposes ``loss_fn(model, batch)``, which
the launch layer wraps into train and eval steps with the optimizer.  The
LM family also has ``init_cache`` / ``decode_step``.
"""
