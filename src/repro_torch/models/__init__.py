"""Model zoo of the port (the slices ported so far).

Families:
  - GNNs (gcn) — gnn/
  - RecSys (dlrm) — recsys/

Each model is an ``nn.Module`` built from its config, a device and a
``torch.Generator``; its family exposes ``loss_fn(model, batch)``, which
the launch layer wraps into train and eval steps with the optimizer.  The
LM family (transformer, MoE) and the other GNNs come with later slices.
"""
