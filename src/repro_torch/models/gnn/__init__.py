from repro_torch.models.gnn import gcn
from repro_torch.models.gnn.common import segment_mean, segment_softmax_norm

__all__ = ["gcn", "segment_mean", "segment_softmax_norm"]
