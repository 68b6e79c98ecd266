"""Queries a batched dispatch answered, as the scheduler's
``repro_batch_size`` histogram counts them over the traced window."""


def read(rec):
    total, count = rec.get("batch_sum", 0.0), rec.get("batch_count", 0)
    if not count:
        return None
    return total / count, "queries/batch"
