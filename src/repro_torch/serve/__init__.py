"""repro_torch.serve — the pieces of the serving layer the engine uses:
structural query canonicalization (:mod:`repro_torch.serve.fingerprint`)
and the bounded LRU plan cache (:mod:`repro_torch.serve.cache`)."""
