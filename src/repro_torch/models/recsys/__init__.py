from repro_torch.models.recsys import dlrm

__all__ = ["dlrm"]
