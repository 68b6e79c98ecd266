"""repro_torch — the TurboHOM++ RDF engine on PyTorch and CUDA (Hopper).

A port of the JAX/Pallas package ``repro`` to PyTorch, with every on-path
Pallas TPU kernel replaced by a CUDA C++ kernel written for ``sm_90a``
(:mod:`repro_torch.kernels`).  The host layers (RDF model, statistics,
signature/summary indexes, planner, fingerprints, resilience policy) are
numpy copies of the reference's; the executor and the SPARQL engine are
reimplemented on torch tensors.  Entry points take ``device=`` and default
to ``"cuda"``; without CUDA they raise unless the caller asks for
``"cpu"``, where every kernel runs its plain PyTorch version.
"""
