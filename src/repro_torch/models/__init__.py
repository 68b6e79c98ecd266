"""Model zoo of the port (the slices ported so far).

Families:
  - dense decoder-only LMs (transformer: Qwen2, Qwen3, Minitron)
  - GNNs (gcn) — gnn/
  - RecSys (dlrm) — recsys/

Each model is an ``nn.Module`` built from its config, a device and a
``torch.Generator``; its family exposes ``loss_fn(model, batch)``, which
the launch layer wraps into train and eval steps with the optimizer.  The
LM family also has ``init_cache`` / ``decode_step``.  MoE and MLA
(DeepSeek-V2, DBRX) and the other GNNs come with later slices.
"""
