from repro_torch.models.gnn import dimenet, gcn, meshgraphnet, pna
from repro_torch.models.gnn.common import segment_mean, segment_softmax_norm

__all__ = ["dimenet", "gcn", "meshgraphnet", "pna", "segment_mean",
           "segment_softmax_norm"]
